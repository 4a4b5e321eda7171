// The GEMM core of kernels C and F on Hopper: Y = A @ W with A bf16 rows (M, K) and
// W the bf16 weight, (K, N) row-major, f32 accumulators, and one of three
// epilogues:
//   * bias [+ exact-erf GELU], rounded to bf16 (C's first product, F's q|k|v);
//   * bias + residual (f32 rows) + LayerNorm in f32 (C's second product, F's out
//     projection), the LayerNorm's row sums traded between the CTAs of a
//     thread-block cluster that spans the row;
//   * raw f32 partial 64 x 64 tiles of a K slice, summed by a second pass that
//     runs either epilogue (rows_reduce_bias_kernel, rows_reduce_ln_kernel): the
//     split-K route of few rows, and the LayerNorm's route where its clusters
//     would not fill the card.
// ops/_cuda.py::gemm_plan picks the tile, the K split and the route from the
// shape (a GemmPlan, common.cuh).
//
// What bounds it.  At the encode shapes (64 samples x ~210 rows = 13,440 rows,
// 768 -> 3072 -> 768) each product is 63 GFLOP: 64 us of bf16 tensor-core work at
// 989 TFLOP/s against ~25 us of bytes at 3.35 TB/s, so the tensor cores bound it
// and only wgmma reaches their rate.  At the decode and TextBert shapes (64 and
// 640 rows) the weights' bytes bound it (4.7 MB per product at d_ff 3072), and the
// card reads them at its rate only when most of its 132 SMs pull disjoint slices.
//
// The design.  Each CTA computes bm x bn output tiles (bm 64 or 128: one or two
// consumer warpgroups of 64 rows; bn 64, 128 or 256) over one K slice.  A ring
// of three or four stages in shared memory, each a 64-deep K block of A (bm x 64)
// and W (64 x bn), is fed by TMA (cp.async.bulk.tensor, 128-byte swizzle,
// completion on an mbarrier with the stage's byte count) from one thread of a
// producer warpgroup; the consumers wait on the stage's `full` barrier, issue
// four wgmma m64nBNk16 (A K-major, W MN-major through the transpose bit) per
// stage, keep one group of products in flight, and release the previous stage
// on its `empty` barrier.  With two consumer warpgroups the producer gives up
// registers (setmaxnreg 40) and the consumers take 232, for the 128
// accumulators of a 64 x 256 tile.  Ragged rows and columns: TMA zero-fills what
// lies outside the matrix, and the epilogues mask their stores and LayerNorm
// sums.
//
// The bias epilogues are persistent: one CTA per SM (two with one consumer
// warpgroup) walks the tiles, its producer running ahead into the next tile's
// K blocks while the consumers round the last tile to bf16 into a staging
// buffer beside the ring, laid out as the output map's swizzled boxes, from
// which one thread writes it with TMA stores.  At C's first product (K 768,
// 1,260 tiles of 128 x 256) a tile's epilogue is as long as a third of its
// products, and one-CTA-a-tile launches left the tensor cores idle through
// every epilogue and every pipeline fill.
//
// The LayerNorm epilogue: N = hd is cut into hd / bn CTAs of 128 rows x bn
// columns (3 at hd 768, bn 256), launched as one cluster per row block.  Each
// CTA adds the bias and the residual to its accumulators, sums its columns of
// every row (in registers, then over the row's four lanes), publishes the sums in
// its shared memory, and after a cluster barrier reads its peers' through
// distributed shared memory (mapa + ld.shared::cluster): the mean.  The centred
// sum of squares goes the same way, then each CTA normalises and writes its
// columns; a last barrier keeps every CTA alive until its peers have read it.
// So no block streams the whole weight for a few rows, which is what bounded
// the port's first row-owning GEMM (32 rows a block, 420 blocks each reading all
// 4.7 MB of W2 at C's second product).
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace ovq {
namespace {

constexpr int kBK = 64;  // K per stage: one 128-byte swizzled row of bf16
constexpr int kStages = 4;
enum Epi { kEpiBias = 0, kEpiGelu = 1, kEpiPartial = 2, kEpiLn = 3 };

struct GemmArgs {
  const float* bias;   // (N,)
  const float* R;      // LayerNorm: the residual rows (M, N)
  const float* gamma;  // LayerNorm scale and shift (N,)
  const float* beta;
  void* Y;  // bf16 (M, N); LayerNorm f32 (M, N); partial f32 (splits, M, N)
  int M, N, K, k_slice;
  float eps;
};

constexpr int kSmemLimit = 232448;  // dynamic shared memory of one CTA on the H100
constexpr int kSmemPerSm = 233472;  // of all CTAs on one SM (1 KB of it reserved per CTA)

template <int WG, int BN, int EPI>
struct Tile {
  // the bias epilogues walk every tile in turn (one CTA per SM, or two with one
  // consumer warpgroup) and stage each bf16 tile for a TMA store beside the ring
  static constexpr bool kPersistent = EPI == kEpiBias || EPI == kEpiGelu;
  static constexpr int BM = 64 * WG;
  static constexpr int kA = BM * kBK * 2;  // bytes of one stage's A tile
  static constexpr int kB = kBK * BN * 2;  // and of its W tile (BN / 64 boxes of 64 x 64)
  static constexpr int kStage = kA + kB;
  static constexpr int kOut = kPersistent ? BM * BN * 2 : 0;
  // the alignment pad, the barriers, two floats per row for the LayerNorm
  static constexpr int kFixed = 1024 + 2 * 4 * 8 + 2 * BM * 4;
  static constexpr int kCtasPerSm = WG == 1 ? 2 : 1;
  static constexpr int kBudget = WG == 1 ? kSmemPerSm / 2 - 1024 : kSmemLimit;
  // as many stages as fit, up to four
  static constexpr int kStages =
      (kBudget - kOut - kFixed) / kStage < 4 ? (kBudget - kOut - kFixed) / kStage : 4;
  static constexpr int kSmem = kFixed + kStages * kStage + kOut;
  static constexpr int kThreads = 128 * (WG + 1);
  static_assert(kStages >= 3 && kSmem <= kBudget, "the ring does not fit");
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(acc, da, db);
  else if constexpr (BN == 128)
    wgmma_m64n128k16(acc, da, db);
  else
    wgmma_m64n64k16(acc, da, db);
}

template <int WG, int BN, int EPI>
__device__ __forceinline__ void gemm_body(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                          const CUtensorMap* y_map, const GemmArgs& args) {
  using T = Tile<WG, BN, EPI>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* out_tile = smem + S * T::kStage;  // the bias epilogues' staged tile
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tile + T::kOut);
  uint64_t* empty = full + S;
  float* row_sums = reinterpret_cast<float*>(empty + S);  // [BM]
  float* row_sqs = row_sums + T::BM;                        // [BM]

  const int M = args.M, N = args.N;
  const int tiles_n = (N + BN - 1) / BN;
  // persistent: every tile in turn, row blocks outermost; else this CTA's own
  // tile (blockIdx.x, blockIdx.y) over K slice blockIdx.z
  const int n_tiles = T::kPersistent ? tiles_n * ((M + T::BM - 1) / T::BM) : 1;
  const int first = T::kPersistent ? blockIdx.x : 0, step = T::kPersistent ? gridDim.x : 1;
  const int k0 = T::kPersistent ? 0 : blockIdx.z * args.k_slice;
  const int nk = (min(args.K, k0 + args.k_slice) - k0 + kBK - 1) / kBK;
  auto origin = [&](int tile, int& m0, int& n0) {
    m0 = (T::kPersistent ? tile / tiles_n : (int)blockIdx.y) * T::BM;
    n0 = (T::kPersistent ? tile % tiles_n : (int)blockIdx.x) * BN;
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * WG) {
    // the producer warpgroup: one thread keeps the ring full, running ahead
    // into the next tile while the consumers finish the last one
    if constexpr (WG == 2) regs_dealloc<40>();
    if (tid == 128 * WG) {
      int it = 0;  // k-blocks loaded, over all tiles
      for (int tile = first; tile < n_tiles; tile += step) {
        int m0, n0;
        origin(tile, m0, n0);
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kStage);
          unsigned char* a = smem + s * T::kStage;
          const int kc = k0 + i * kBK;
          tma_load_2d(a, a_map, &full[s], kc, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(a + T::kA + j * kBK * 128, b_map, &full[s], n0 + 64 * j, kc);
        }
      }
    }
    if constexpr (EPI == kEpiLn) {
      // the consumers' three cluster barriers count every thread of the cluster
#pragma unroll 1
      for (int u = 0; u < 3; ++u) {
        cluster_arrive();
        cluster_wait();
      }
    }
    return;
  }

  if constexpr (WG == 2) regs_alloc<232>();
  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int lr0 = wg * 64 + w * 16 + g;  // this lane's rows in the tile: lr0, lr0 + 8
  int it = 0;                            // k-blocks consumed, over all tiles
  for (int tile = first; tile < n_tiles; tile += step) {
    int m0, n0;
    origin(tile, m0, n0);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const unsigned char* a = smem + s * T::kStage + wg * 64 * 128;
      const unsigned char* b = smem + s * T::kStage + T::kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_tile<BN>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                       sw128_desc(b + 2048 * kk, kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (i > 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(it - 1) % S]);
    fence_operands(acc);

    const int r0 = m0 + lr0, r1 = r0 + 8;
    if constexpr (T::kPersistent) {
      // bias [+ GELU] to bf16 in shared memory, laid out as the TMA boxes of the
      // output map (BN / 64 boxes of BM rows x 128 bytes, 128-byte swizzle:
      // conflict-free, the 8 rows of a store instruction in 8 distinct chunks),
      // then one thread stores the tile; the map clips rows and columns past the
      // matrix.  The previous tile's store must have read the buffer first.
      if (tid == 0) bulk_wait_all<true>();
      named_barrier(1, 128 * WG);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * t, c = n0 + cl;
        const float b0 = c < N ? args.bias[c] : 0.0f, b1 = c < N ? args.bias[c + 1] : 0.0f;
        float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                      acc[4 * j + 3] + b1};
        if constexpr (EPI == kEpiGelu) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
        }
        unsigned char* box = out_tile + (cl / 64) * (T::BM * 128) + (((cl % 64) / 8) ^ g) * 16 +
                             (cl % 8) * 2;
        *reinterpret_cast<unsigned*>(box + lr0 * 128) = pack_bf16(v[0], v[1]);
        *reinterpret_cast<unsigned*>(box + (lr0 + 8) * 128) = pack_bf16(v[2], v[3]);
      }
      fence_async_shared();
      named_barrier(1, 128 * WG);
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          if (n0 + 64 * j < N) tma_store_2d(y_map, out_tile + j * (T::BM * 128), n0 + 64 * j, m0);
        bulk_commit();
      }
    } else if constexpr (EPI == kEpiPartial) {
      float* P = static_cast<float*>(args.Y) + (size_t)blockIdx.z * M * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= N) continue;  // N % 8 == 0: both columns in or both out
        if (r0 < M)
          *reinterpret_cast<float2*>(P + (size_t)r0 * N + c) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r1 < M)
          *reinterpret_cast<float2*>(P + (size_t)r1 * N + c) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
      // LayerNorm over the cluster's CTAs: N == gridDim.x * BN, one cluster per row block
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        const float b0 = args.bias[c], b1 = args.bias[c + 1];
        const float2 x0 = r0 < M ? *reinterpret_cast<const float2*>(args.R + (size_t)r0 * N + c)
                                 : make_float2(0.f, 0.f);
        const float2 x1 = r1 < M ? *reinterpret_cast<const float2*>(args.R + (size_t)r1 * N + c)
                                 : make_float2(0.f, 0.f);
        acc[4 * j] = acc[4 * j] + b0 + x0.x;
        acc[4 * j + 1] = acc[4 * j + 1] + b1 + x0.y;
        acc[4 * j + 2] = acc[4 * j + 2] + b0 + x1.x;
        acc[4 * j + 3] = acc[4 * j + 3] + b1 + x1.y;
        s0 += acc[4 * j] + acc[4 * j + 1];
        s1 += acc[4 * j + 2] + acc[4 * j + 3];
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (t == 0) {
        row_sums[lr0] = s0;
        row_sums[lr0 + 8] = s1;
      }
      cluster_arrive();
      cluster_wait();
      const unsigned ranks = gridDim.x;
      float tot0 = 0.0f, tot1 = 0.0f;
      for (unsigned r = 0; r < ranks; ++r) {
        tot0 += ld_peer(row_sums + lr0, r);
        tot1 += ld_peer(row_sums + lr0 + 8, r);
      }
      const float mean0 = tot0 / N, mean1 = tot1 / N;
      float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float d0 = acc[4 * j] - mean0, d1 = acc[4 * j + 1] - mean0;
        const float d2 = acc[4 * j + 2] - mean1, d3 = acc[4 * j + 3] - mean1;
        q0 += d0 * d0 + d1 * d1;
        q1 += d2 * d2 + d3 * d3;
      }
      q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
      q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
      q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
      if (t == 0) {
        row_sqs[lr0] = q0;
        row_sqs[lr0 + 8] = q1;
      }
      cluster_arrive();
      cluster_wait();
      tot0 = tot1 = 0.0f;
      for (unsigned r = 0; r < ranks; ++r) {
        tot0 += ld_peer(row_sqs + lr0, r);
        tot1 += ld_peer(row_sqs + lr0 + 8, r);
      }
      cluster_arrive();  // this CTA has read its peers' sums
      const float rstd0 = rsqrtf(tot0 / N + args.eps), rstd1 = rsqrtf(tot1 / N + args.eps);
      float* Y = static_cast<float*>(args.Y);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        const float ga = args.gamma[c], gb = args.gamma[c + 1];
        const float ba = args.beta[c], bb = args.beta[c + 1];
        if (r0 < M)
          *reinterpret_cast<float2*>(Y + (size_t)r0 * N + c) =
              make_float2((acc[4 * j] - mean0) * rstd0 * ga + ba,
                          (acc[4 * j + 1] - mean0) * rstd0 * gb + bb);
        if (r1 < M)
          *reinterpret_cast<float2*>(Y + (size_t)r1 * N + c) =
              make_float2((acc[4 * j + 2] - mean1) * rstd1 * ga + ba,
                          (acc[4 * j + 3] - mean1) * rstd1 * gb + bb);
      }
      cluster_wait();  // no CTA leaves while a peer may still read its sums
    }
  }
  if constexpr (T::kPersistent) {
    if (tid == 0) bulk_wait_all<false>();  // the last tile's store is done before the CTA leaves
  }
}

// three kernel names, so that a profile tells the products apart
// (y_map: the bias epilogues' output; the others pass a_map again, unread)
template <int WG, int BN, int EPI>
__global__ void __launch_bounds__(128 * (WG + 1), WG == 1 ? 2 : 1)
    gemm_bias_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap b_map,
                          const __grid_constant__ CUtensorMap y_map, const GemmArgs args) {
  gemm_body<WG, BN, EPI>(&a_map, &b_map, &y_map, args);
}
template <int WG, int BN>
__global__ void __launch_bounds__(128 * (WG + 1), WG == 1 ? 2 : 1)
    gemm_partial_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                             const __grid_constant__ CUtensorMap b_map,
                             const __grid_constant__ CUtensorMap y_map, const GemmArgs args) {
  gemm_body<WG, BN, kEpiPartial>(&a_map, &b_map, &y_map, args);
}
template <int BN>
__global__ void __launch_bounds__(384, 1)
    gemm_ln_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap y_map, const GemmArgs args) {
  gemm_body<2, BN, kEpiLn>(&a_map, &b_map, &y_map, args);
}

// Y (bf16) = epi(bias + the `splits` f32 (M, N) slices of `partial`), four columns
// a thread
template <bool GELU>
__global__ void __launch_bounds__(256)
    rows_reduce_bias_kernel(const float* __restrict__ partial, int splits,
                            const float* __restrict__ bias, bf16* __restrict__ Y, int M, int N) {
  const long long quads = (long long)M * N / 4, slice = (long long)M * N;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < quads;
       q += (long long)gridDim.x * blockDim.x)
    reduce_bias_quad<GELU>(partial, splits, bias, Y, 4 * q, slice, N);
}

// Y (f32) = LayerNorm(bias + R + the `splits` f32 (M, N) slices of `partial`) *
// gamma + beta; one block of kRowThreads per row, up to four columns a thread
__global__ void __launch_bounds__(kRowThreads)
    rows_reduce_ln_kernel(const float* __restrict__ partial, int splits,
                          const float* __restrict__ bias, const float* __restrict__ R,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          float* __restrict__ Y, int M, int N, float eps) {
  __shared__ float scratch[kRowThreads / 32];
  reduce_ln_row(partial, splits, bias, R, gamma, beta, Y, nullptr, M, N, eps, blockIdx.x,
                scratch);
}

cudaError_t launch_rows_reduce_ln(const float* partial, int splits, const float* bias,
                                  const float* R, const float* gamma, const float* beta, float* Y,
                                  int M, int N, float eps, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N > 4 * kRowThreads || splits < 1) return cudaErrorInvalidValue;
  rows_reduce_ln_kernel<<<M, kRowThreads, 0, stream>>>(partial, splits, bias, R, gamma, beta, Y,
                                                       M, N, eps);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(256)
    cast_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ y, long long quads) {
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < quads;
       q += (long long)gridDim.x * blockDim.x)
    cast_quad(x, y, q);
}

int elementwise_blocks(long long quads) {
  const long long blocks = (quads + 255) / 256;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

// -- tensor maps ------------------------------------------------------------------
// cuTensorMapEncodeTiled from the driver, through the runtime (the library links
// no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* p;
  int rows, cols, box_rows;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && cols == o.cols && box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    for (int v : {k.rows, k.cols, k.box_rows}) h = h * 1000003u ^ std::hash<int>()(v);
    return h;
  }
};

// The map of a bf16 (rows, cols) row-major matrix read in boxes of box_rows x 64
// columns with the 128-byte swizzle, zero-filled outside.  A map is a function of
// (pointer, shape, box) alone, so it is built once per key and cached: the
// weights' on their first call, the workspaces' whenever the allocator hands out
// a new address.
bool tensor_map(CUtensorMap* out, const bf16* p, int rows, int cols, int box_rows) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{p, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t element_strides[2] = {1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims, strides, box,
             element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return true;
}

template <typename Kernel>
cudaError_t launch_tile(Kernel kernel, int smem, int threads, dim3 grid, int cluster,
                        const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& y,
                        const GemmArgs& args, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, a, b, y, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    return cudaGetDevice(&device) == cudaSuccess &&
                   cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess
               ? n
               : 132;
  }();
  return count;
}

// one launch of the GEMM with epilogue EPI on tile (WG, BN): the bias epilogues
// persistent, one CTA per SM (two with one consumer warpgroup) walking the
// tiles; the others on a grid (N tiles, M tiles, splits).  The shared-memory
// ceiling is set once per instance.
template <int WG, int BN, int EPI>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& y,
                        const GemmArgs& args, int splits, int cluster, cudaStream_t stream) {
  using T = Tile<WG, BN, EPI>;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const GemmArgs);
  if constexpr (EPI == kEpiLn)
    kernel = gemm_ln_sm90_kernel<BN>;
  else if constexpr (EPI == kEpiPartial)
    kernel = gemm_partial_sm90_kernel<WG, BN>;
  else
    kernel = gemm_bias_sm90_kernel<WG, BN, EPI>;
  static const cudaError_t attribute =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attribute != cudaSuccess) return attribute;
  const int tiles_n = (args.N + BN - 1) / BN, tiles_m = (args.M + T::BM - 1) / T::BM;
  const int ctas = T::kCtasPerSm * sm_count();
  const dim3 grid = T::kPersistent ? dim3(tiles_n * tiles_m < ctas ? tiles_n * tiles_m : ctas)
                                   : dim3(tiles_n, tiles_m, splits);
  return launch_tile(kernel, T::kSmem, T::kThreads, grid, cluster, a, b, y, args, stream);
}

// the plan's shape checks shared by both epilogues; false for what no kernel takes
bool plan_ok(const GemmPlan& p, int M, int N, int K) {
  const bool tile = (p.bm == 128 && (p.bn == 256 || p.bn == 128)) ||
                    (p.bm == 64 && (p.bn == 128 || p.bn == 64));
  return tile && N > 0 && K > 0 && N % 8 == 0 && K % 8 == 0 && p.splits >= 1 &&
         p.k_slice > 0 && p.k_slice % kBK == 0 && (long long)p.splits * p.k_slice >= K &&
         (long long)(p.splits - 1) * p.k_slice < K && (p.cluster == 0 || p.splits == 1) &&
         p.splits <= 65535 && (M + 63) / 64 <= 65535;
}

// the raw f32 partial tiles of a split (cluster 0) plan, 64 x 64 tiles
cudaError_t launch_partial(const CUtensorMap& a, const CUtensorMap& b, GemmArgs args,
                           float* partial, const GemmPlan& p, cudaStream_t stream) {
  if (p.bm != 64 || p.bn != 64) return cudaErrorInvalidValue;
  args.Y = partial;
  return launch_gemm<1, 64, kEpiPartial>(a, b, a, args, p.splits, 1, stream);
}

}  // namespace

cudaError_t sm90_gemm_bias(const bf16* A, const bf16* W, const float* bias, bf16* Y,
                           float* partial, int M, int N, int K, bool gelu, GemmPlan p,
                           cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (!plan_ok(p, M, N, K) || p.cluster > 1 || (p.cluster == 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap a, b, y;
  if (!tensor_map(&a, A, M, K, p.bm) || !tensor_map(&b, W, K, N, kBK) ||
      !tensor_map(&y, Y, M, N, p.bm))
    return cudaErrorInvalidValue;
  GemmArgs args{bias, nullptr, nullptr, nullptr, Y, M, N, K, p.k_slice, 0.0f};
  if (p.cluster == 0) {
    cudaError_t err = launch_partial(a, b, args, partial, p, stream);
    if (err != cudaSuccess) return err;
    const long long quads = (long long)M * N / 4;
    if (gelu)
      rows_reduce_bias_kernel<true><<<elementwise_blocks(quads), 256, 0, stream>>>(
          partial, p.splits, bias, Y, M, N);
    else
      rows_reduce_bias_kernel<false><<<elementwise_blocks(quads), 256, 0, stream>>>(
          partial, p.splits, bias, Y, M, N);
    return cudaGetLastError();
  }
#define OVQ_BIAS_TILE(TBM, TBN)                                                        \
  if (p.bm == TBM && p.bn == TBN)                                                      \
    return gelu ? launch_gemm<TBM / 64, TBN, kEpiGelu>(a, b, y, args, 1, 1, stream)    \
                : launch_gemm<TBM / 64, TBN, kEpiBias>(a, b, y, args, 1, 1, stream);
  OVQ_BIAS_TILE(128, 256)
  OVQ_BIAS_TILE(128, 128)
  OVQ_BIAS_TILE(64, 128)
  OVQ_BIAS_TILE(64, 64)
#undef OVQ_BIAS_TILE
  return cudaErrorInvalidValue;
}

cudaError_t sm90_gemm_ln(const bf16* A, const bf16* W, const float* bias, const float* R,
                         const float* gamma, const float* beta, float* Y, float* partial, int M,
                         int N, int K, float eps, GemmPlan p, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (!plan_ok(p, M, N, K) || N % 128 || N > 1024 || (p.cluster == 0 && partial == nullptr) ||
      (p.cluster > 0 && (p.bm != 128 || p.cluster * p.bn != N || p.cluster > 8)))
    return cudaErrorInvalidValue;
  CUtensorMap a, b;
  if (!tensor_map(&a, A, M, K, p.bm) || !tensor_map(&b, W, K, N, kBK)) return cudaErrorInvalidValue;
  const GemmArgs args{bias, R, gamma, beta, Y, M, N, K, p.k_slice, eps};
  if (p.cluster == 0) {
    const cudaError_t err = launch_partial(a, b, args, partial, p, stream);
    if (err != cudaSuccess) return err;
    return launch_rows_reduce_ln(partial, p.splits, bias, R, gamma, beta, Y, M, N, eps, stream);
  }
  return p.bn == 256 ? launch_gemm<2, 256, kEpiLn>(a, b, a, args, 1, p.cluster, stream)
                     : launch_gemm<2, 128, kEpiLn>(a, b, a, args, 1, p.cluster, stream);
}

bool bf16_tensor_map(CUtensorMap* out, const bf16* p, int rows, int cols, int box_rows) {
  return tensor_map(out, p, rows, cols, box_rows);
}

cudaError_t cast_to_bf16(const float* x, bf16* y, long long n, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (n % 4) return cudaErrorInvalidValue;
  cast_bf16_kernel<<<elementwise_blocks(n / 4), 256, 0, stream>>>(x, y, n / 4);
  return cudaGetLastError();
}

}  // namespace ovq

extern "C" const char* ovq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
