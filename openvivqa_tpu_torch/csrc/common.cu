// The first building blocks of the port's kernels, on f32 activations (kernel D and
// the two-bias attention entry): a bf16 tensor-core GEMM with a bias epilogue, a
// GEMM whose blocks own whole rows so that the residual add and the LayerNorm run
// in its epilogue (split over K when there are too few rows to fill the card), and
// a tensor-core softmax attention over packed (rows, heads * head_dim) layouts.
// See common.cuh for the contracts.  Kernels C and F run on gemm_sm90.cu's wgmma +
// TMA core and block B, kernels A, B, E and the decoder-layer step on the
// persistent step kernel (decoder_layer_step.cu), the streamed attention on its
// own block instead.
//
// These are first versions: nvcuda::wmma 16x16x16 bf16 fragments with f32
// accumulators (mma.sync, not Hopper's wgmma), weight tiles brought into shared
// memory with cp.async two K-slices deep, activations converted to bf16 on their
// way through registers.  No TMA, no warp specialisation.  What bounds each kernel
// on the H100 is in its own source note.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace ovq {

using namespace nvcuda;

constexpr int kBK = 32;          // K-slice of every GEMM stage
constexpr int kLdAs = kBK + 8;   // bf16 row stride of an A slice (80 bytes)
constexpr int kThreads = 256;    // 8 warps in every GEMM block
static_assert(kThreads == kRowThreads, "rows_reduce_ln_kernel runs reduce_ln_row");

// -- staging helpers ----------------------------------------------------------
// 16-byte asynchronous copy global -> shared; src_size 0 zero-fills the chunk
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// ---------------------------------------------------------------------------
// GEMM + bias: BM x 128 output tiles, 8 warps as 2 x 4, each warp a
// (BM / 2) x 32 tile; epilogue fragment by fragment through a per-warp 16x16
// staging tile, eight columns per lane
// ---------------------------------------------------------------------------
template <typename TA, typename TO, int BM>
__global__ void __launch_bounds__(kThreads)
    gemm_bias_kernel(const TA* __restrict__ A, int lda, const bf16* __restrict__ W,
                     const float* __restrict__ bias, TO* __restrict__ Y, int ldy, int M, int N,
                     int K) {
  constexpr int BN = 128;
  constexpr int kLdBs = BN + 8;
  constexpr int MF = BM / 32;  // 16-row fragments per warp
  constexpr int kAQuads = BM * kBK / 4 / kThreads;
  __shared__ __align__(128) bf16 As[2][BM * kLdAs];
  __shared__ __align__(128) bf16 Bs[2][kBK * kLdBs];
  __shared__ __align__(128) float stage_all[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int wr = (warp / 4) * (BM / 2), wc = (warp % 4) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint2 a_regs[kAQuads];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAQuads; ++i) {
      const int idx = tid + i * kThreads, r = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
      const int gr = row0 + r;
      a_regs[i] = load_quad(A + (size_t)(gr < M ? gr : 0) * lda + k0 + c, gr < M);
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAQuads; ++i) {
      const int idx = tid + i * kThreads, r = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
      *reinterpret_cast<uint2*>(&As[buf][r * kLdAs + c]) = a_regs[i];
    }
  };
  auto load_b = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kBK * BN / 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
      const bool valid = col0 + c < N;
      cp_async16(&Bs[buf][r * kLdBs + c], W + (size_t)(k0 + r) * N + (valid ? col0 + c : 0),
                 valid);
    }
    cp_async_commit();
  };

  const int nk = K / kBK;
  load_b(0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_b(nxt, (kt + 1) * kBK);
      load_a((kt + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[MF];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        wmma::load_matrix_sync(a[i], &As[cur][(wr + 16 * i) * kLdAs + kk], kLdAs);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[cur][kk * kLdBs + wc + 16 * j], kLdBs);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_a(nxt);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  float* stage = stage_all[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wr + 16 * i + r, gc = col0 + wc + 16 * j + c;
      if (gr < M && gc < N) {  // N % 8 == 0: the eight columns are all in or all out
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = stage[r * 16 + c + u] + bias[gc + u];
        store_eight(Y + (size_t)gr * ldy + gc, v);
      }
      __syncwarp();
    }
}

template <typename TA, typename TO>
cudaError_t launch_gemm_bias(const TA* A, int lda, const bf16* W, const float* bias, TO* Y,
                             int ldy, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % kBK || N % 8 || lda % 4 || ldy % 8) return cudaErrorInvalidValue;
  const int tiles_n = (N + 127) / 128;
  // 128-row tiles once they fill the card, else 64-row tiles for more blocks
  if ((long long)((M + 127) / 128) * tiles_n >= 132) {
    gemm_bias_kernel<TA, TO, 128><<<dim3(tiles_n, (M + 127) / 128), kThreads, 0, stream>>>(
        A, lda, W, bias, Y, ldy, M, N, K);
  } else {
    gemm_bias_kernel<TA, TO, 64><<<dim3(tiles_n, (M + 63) / 64), kThreads, 0, stream>>>(
        A, lda, W, bias, Y, ldy, M, N, K);
  }
  return cudaGetLastError();
}

template cudaError_t launch_gemm_bias<float, float>(const float*, int, const bf16*, const float*,
                                                    float*, int, int, int, int, cudaStream_t);

// ---------------------------------------------------------------------------
// GEMM + bias + residual + LayerNorm: 32 whole rows per block, 8 warps; warp w
// owns output columns [w * 16 * NF, (w + 1) * 16 * NF) of N = 128 * NF.  With
// gridDim.y > 1 each block sums one K-range and writes its raw partial rows;
// rows_reduce_ln_kernel then adds the partials and runs the epilogue.
// ---------------------------------------------------------------------------
constexpr int kRowsBM = 32;

template <int NF>
constexpr size_t rows_smem_bytes() {
  // two stages of (A slice, W slice) and, after the K loop, the f32 row block
  return (2 * kRowsBM * kLdAs * 2 + 2 * kBK * (128 * NF + 8) * 2) >
                 (kRowsBM * (128 * NF + 4) * 4)
             ? (2 * kRowsBM * kLdAs * 2 + 2 * kBK * (128 * NF + 8) * 2)
             : (kRowsBM * (128 * NF + 4) * 4);
}

// y = LayerNorm(row) * gamma + beta for one row held in shared memory, by one warp
__device__ __forceinline__ void warp_layer_norm(const float* row, const float* gamma,
                                                const float* beta, float* y, int n, float eps,
                                                int lane) {
  float sum = 0.0f;
  for (int c = lane; c < n; c += 32) sum += row[c];
  const float mean = warp_sum(sum) / n;
  float sq = 0.0f;
  for (int c = lane; c < n; c += 32) {
    const float centred = row[c] - mean;
    sq += centred * centred;
  }
  const float rstd = rsqrtf(warp_sum(sq) / n + eps);
  for (int c = lane; c < n; c += 32) y[c] = (row[c] - mean) * rstd * gamma[c] + beta[c];
}

template <typename TA, int NF>
__global__ void __launch_bounds__(kThreads)
    gemm_rows_kernel(const TA* __restrict__ A, int lda, const bf16* __restrict__ W,
                     const float* __restrict__ bias, const float* __restrict__ R,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     float* __restrict__ Y, float* __restrict__ partial, int M, int K,
                     int k_per_split, float eps) {
  constexpr int N = 128 * NF;
  constexpr int kLdB = N + 8;
  constexpr int kLdC = N + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][kRowsBM * kLdAs]
  bf16* Bs = As + 2 * kRowsBM * kLdAs;       // [2][kBK * kLdB]
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * kRowsBM;
  const int wc = warp * 16 * NF;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // one quad of the 32 x 32 A slice per thread
  const int ar = tid / (kBK / 4), ac = (tid % (kBK / 4)) * 4;
  const int agr = row0 + ar;
  uint2 a_reg;
  auto load_a = [&](int k0) {
    a_reg = load_quad(A + (size_t)(agr < M ? agr : 0) * lda + k0 + ac, agr < M);
  };
  auto store_a = [&](int buf) {
    *reinterpret_cast<uint2*>(As + buf * kRowsBM * kLdAs + ar * kLdAs + ac) = a_reg;
  };
  auto load_b = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kBK * N / 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx / (N / 8), c = (idx % (N / 8)) * 8;
      cp_async16(Bs + buf * kBK * kLdB + r * kLdB + c, W + (size_t)(k0 + r) * N + c, true);
    }
    cp_async_commit();
  };

  const int nk = (k_end - k_begin) / kBK;
  if (nk > 0) {
    load_b(0, k_begin);
    load_a(k_begin);
    store_a(0);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_b(nxt, k_begin + (kt + 1) * kBK);
      load_a(k_begin + (kt + 1) * kBK);
    }
    const bf16* as = As + cur * kRowsBM * kLdAs;
    const bf16* bs = Bs + cur * kBK * kLdB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], as + (16 * i) * kLdAs + kk, kLdAs);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, bs + kk * kLdB + wc + 16 * j, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    if (more) {
      store_a(nxt);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // the stages are dead after the last __syncthreads: the row block takes their place
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(Cs + (16 * i) * kLdC + wc + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int r = warp; r < kRowsBM; r += kThreads / 32) {
    const int gr = row0 + r;
    if (gr >= M) break;
    float* crow = Cs + r * kLdC;
    if (gridDim.y == 1) {
      const float* rrow = R + (size_t)gr * N;
      for (int c = lane; c < N; c += 32) crow[c] += bias[c] + rrow[c];
      __syncwarp();
      warp_layer_norm(crow, gamma, beta, Y + (size_t)gr * N, N, eps, lane);
    } else {
      float* prow = partial + ((size_t)blockIdx.y * M + gr) * N;
      for (int c = lane * 4; c < N; c += 128)
        *reinterpret_cast<float4*>(prow + c) = *reinterpret_cast<const float4*>(crow + c);
    }
  }
}

// the K-split partials of each row summed, + bias + residual, then LayerNorm;
// one block of kThreads (= kRowThreads) per row, up to four columns per thread
__global__ void __launch_bounds__(kThreads)
    rows_reduce_ln_kernel(const float* __restrict__ partial, int splits,
                          const float* __restrict__ bias, const float* __restrict__ R,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          float* __restrict__ Y, int M, int N, float eps) {
  __shared__ float scratch[kThreads / 32];
  reduce_ln_row(partial, splits, bias, R, gamma, beta, Y, nullptr, M, N, eps, blockIdx.x,
                scratch);
}

cudaError_t launch_rows_reduce_ln(const float* partial, int splits, const float* bias,
                                  const float* R, const float* gamma, const float* beta, float* Y,
                                  int M, int N, float eps, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N > 4 * kThreads || splits < 1) return cudaErrorInvalidValue;
  rows_reduce_ln_kernel<<<M, kThreads, 0, stream>>>(partial, splits, bias, R, gamma, beta, Y, M, N,
                                                    eps);
  return cudaGetLastError();
}

template <typename TA, int NF>
static cudaError_t launch_rows(const TA* A, int lda, const bf16* W, const float* bias,
                               const float* R, const float* gamma, const float* beta, float* Y,
                               float* partial, int splits, int k_per_split, int M, int K,
                               float eps, cudaStream_t stream) {
  constexpr size_t smem = rows_smem_bytes<NF>();
  cudaError_t err = cudaFuncSetAttribute(gemm_rows_kernel<TA, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_rows_kernel<TA, NF><<<dim3((M + kRowsBM - 1) / kRowsBM, splits), kThreads, smem, stream>>>(
      A, lda, W, bias, R, gamma, beta, Y, partial, M, K, k_per_split, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_rows_reduce_ln(partial, splits, bias, R, gamma, beta, Y, M, 128 * NF, eps, stream);
}

template <typename TA>
cudaError_t launch_gemm_residual_ln(const TA* A, int lda, const bf16* W, const float* bias,
                                    const float* R, const float* gamma, const float* beta,
                                    float* Y, float* partial, int splits, int k_per_split,
                                    int M, int N, int K, float eps, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (N % 128 || N < 128 || N > 1024 || K <= 0 || K % kBK || lda % 4 || splits < 1 ||
      k_per_split % kBK || (long long)splits * k_per_split < K ||
      (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
#define OVQ_ROWS_CASE(nf)                                                                    \
  case nf:                                                                                   \
    return launch_rows<TA, nf>(A, lda, W, bias, R, gamma, beta, Y, partial, splits,           \
                               k_per_split, M, K, eps, stream);
  switch (N / 128) {
    OVQ_ROWS_CASE(1)
    OVQ_ROWS_CASE(2)
    OVQ_ROWS_CASE(3)
    OVQ_ROWS_CASE(4)
    OVQ_ROWS_CASE(5)
    OVQ_ROWS_CASE(6)
    OVQ_ROWS_CASE(7)
    OVQ_ROWS_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef OVQ_ROWS_CASE
}

template cudaError_t launch_gemm_residual_ln<float>(const float*, int, const bf16*, const float*,
                                                    const float*, const float*, const float*,
                                                    float*, float*, int, int, int, int, int,
                                                    float, cudaStream_t);

// ---------------------------------------------------------------------------
// attention: one block per (64-row q-tile, head, sample), 4 warps, each warp 16
// query rows.  Keys and values stream through shared memory in chunks of 64
// rows (bf16, zero rows past the end), so the block's footprint does not grow
// with the key count.  Two passes over the chunks: the first takes each row's
// max and denominator of the f32 softmax (running, as an online softmax); the
// second recomputes S = Q K^T on the tensor cores, writes the normalised weights
// rounded to bf16 over the scores in place and accumulates O = P V in fragments.
// Normalising before rounding keeps the TPU kernel's (and the plain version's)
// numerics; the price is computing Q K^T twice.  With HB, each
// logit also takes its element of the per-head bias, read from global memory
// like the head-shared one (strides of 0 where it is shared).
// ---------------------------------------------------------------------------
// dynamic shared memory of one attention block, or -1 for shapes it does not take
static long long attention_smem_bytes(int sk, int d) {
  if (sk <= 0 || d % 16 || d > 128) return -1;
  return (kAttnQTile + 2 * kAttnKeyChunk) * (d + 8) * 2LL          // Q tile, K and V chunks
         + kAttnWarps * 16 * (kAttnKeyChunk + 4) * 4LL             // per-warp score chunk
         + kAttnWarps * 256 * 4LL;                                 // per-warp output staging
}

template <typename TI, typename TO, int DF, bool HB>
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const TI* __restrict__ q, long long q_bs, int q_rs,
                     const TI* __restrict__ k, const TI* __restrict__ v, long long kv_bs,
                     int kv_rs, const float* __restrict__ bias, long long bias_bs, int bias_qs,
                     TO* __restrict__ out, long long out_bs, int out_rs, int sq, int sk,
                     float scale, HeadBias hb) {
  constexpr int d = 16 * DF;
  constexpr int ldq = d + 8;
  constexpr int lds = kAttnKeyChunk + 4;  // f32 score row stride
  constexpr int ldp = 2 * lds;            // bf16 weight row stride (same bytes)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kAttnQTile * ldq;
  bf16* Vs = Ks + kAttnKeyChunk * ldq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(Vs + kAttnKeyChunk * ldq) + warp * 16 * lds;
  float* stage = reinterpret_cast<float*>(Vs + kAttnKeyChunk * ldq) +
                 kAttnWarps * 16 * lds + warp * 256;

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kAttnQTile;
  const int w0 = 16 * warp;                // this warp's first row in the tile
  const bool active = i0 + w0 < sq;        // inactive warps still meet every barrier
  const TI* kb = k + b * kv_bs + h * d;
  const TI* vb = v + b * kv_bs + h * d;

  stage_rows<DF>(Qs, ldq, q + b * q_bs + (long long)i0 * q_rs + h * d, q_rs, sq - i0);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DF];
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) wmma::load_matrix_sync(qf[kk], Qs + w0 * ldq + 16 * kk, ldq);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[DF];
#pragma unroll
  for (int j = 0; j < DF; ++j) wmma::fill_fragment(o[j], 0.0f);
  // softmax rows: lanes 2r and 2r + 1 own row r of the warp's 16, 32 columns of
  // each chunk apiece, and keep the row's running max and denominator
  const int sr = lane / 2, half = lane % 2;
  const int si = i0 + w0 + sr;
  const bool row_ok = si < sq;
  const float* brow = bias + b * bias_bs + (long long)(row_ok ? si : 0) * bias_qs;
  const float* hrow =
      HB ? hb.p + b * hb.bs + h * hb.hs + (long long)(row_ok ? si : 0) * hb.qs : nullptr;
  float row_max = -INFINITY, row_sum = 0.0f;

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
    for (int j0 = 0; j0 < sk; j0 += kAttnKeyChunk) {
      __syncthreads();  // the previous chunk is no longer read
      stage_rows<DF>(Ks, ldq, kb + (long long)j0 * kv_rs, kv_rs, sk - j0);
      if (pass == 1)
        stage_rows<DF>(Vs, ldq, vb + (long long)j0 * kv_rs, kv_rs, sk - j0);
      __syncthreads();
      if (!active) continue;

#pragma unroll
      for (int j = 0; j < kAttnKeyChunk / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
        wmma::fill_fragment(s, 0.0f);
#pragma unroll
        for (int kk = 0; kk < DF; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + (16 * j) * ldq + 16 * kk, ldq);
          wmma::mma_sync(s, qf[kk], kf, s);
        }
        wmma::store_matrix_sync(Sw + 16 * j, s, lds, wmma::mem_row_major);
      }
      __syncwarp();

      float* srow = Sw + sr * lds;
      float vals[32];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int c = half * 32 + u;
        if (!(row_ok && j0 + c < sk))
          vals[u] = -INFINITY;
        else if (HB)
          vals[u] = srow[c] * scale + brow[j0 + c] + hrow[j0 + c];
        else
          vals[u] = srow[c] * scale + brow[j0 + c];
        chunk_max = fmaxf(chunk_max, vals[u]);
      }
      chunk_max = fmaxf(chunk_max, __shfl_xor_sync(0xffffffffu, chunk_max, 1));
      if (pass == 0) {
        const float m_new = fmaxf(row_max, chunk_max);
        const float base = row_ok ? m_new : 0.0f;  // rows past the end stay finite
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < 32; ++u) part += expf(vals[u] - base);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (row_ok) {
          row_sum = row_sum * expf(row_max - m_new) + part;
          row_max = m_new;
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < 32; ++u) vals[u] = row_ok ? expf(vals[u] - row_max) / row_sum : 0.0f;
      __syncwarp();  // the row pair has read its scores before the weights overwrite them
      bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
      for (int u = 0; u < 32; ++u) prow[half * 32 + u] = __float2bfloat16(vals[u]);
      __syncwarp();

      const bf16* P = reinterpret_cast<const bf16*>(Sw);
#pragma unroll
      for (int kk = 0; kk < kAttnKeyChunk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::load_matrix_sync(pf, P + 16 * kk, ldp);
#pragma unroll
        for (int j = 0; j < DF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + (16 * kk) * ldq + 16 * j, ldq);
          wmma::mma_sync(o[j], pf, vf, o[j]);
        }
      }
    }
  }
  if (!active) return;

  const int r = lane / 2, c8 = (lane % 2) * 8;
  const int i = i0 + w0 + r;
#pragma unroll
  for (int j = 0; j < DF; ++j) {
    wmma::store_matrix_sync(stage, o[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (i < sq) store_eight(out + b * out_bs + (long long)i * out_rs + h * d + 16 * j + c8,
                            stage + r * 16 + c8);
    __syncwarp();
  }
}

template <typename TI, typename TO, int DF, bool HB>
static cudaError_t launch_attention_df(const TI* q, long long q_bs, int q_rs, const TI* k,
                                       const TI* v, long long kv_bs, int kv_rs,
                                       const float* bias, long long bias_bs, int bias_qs, TO* out,
                                       long long out_bs, int out_rs, int batch, int heads,
                                       int sq, int sk, float scale, long long smem,
                                       cudaStream_t stream, HeadBias hb) {
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<TI, TO, DF, HB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kAttnQTile - 1) / kAttnQTile, heads, batch);
  attention_kernel<TI, TO, DF, HB><<<grid, kAttnThreads, smem, stream>>>(
      q, q_bs, q_rs, k, v, kv_bs, kv_rs, bias, bias_bs, bias_qs, out, out_bs, out_rs, sq, sk,
      scale, hb);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_attention(const TI* q, long long q_bs, int q_rs, const TI* k, const TI* v,
                             long long kv_bs, int kv_rs, const float* bias, long long bias_bs,
                             int bias_qs, TO* out, long long out_bs, int out_rs, int batch,
                             int heads, int sq, int sk, int d, float scale, cudaStream_t stream,
                             HeadBias head_bias) {
  if (batch <= 0 || sq <= 0) return cudaSuccess;
  const long long smem = attention_smem_bytes(sk, d);
  if (smem < 0 || q_rs % 4 || kv_rs % 4 || out_rs % 8 || q_bs % 4 || kv_bs % 4 || out_bs % 8)
    return cudaErrorInvalidValue;
  // only the float instantiation carries the head-bias variant
  constexpr bool kFloatIO = std::is_same<TI, float>::value && std::is_same<TO, float>::value;
  if (head_bias.p != nullptr && !kFloatIO) return cudaErrorInvalidValue;
#define OVQ_ATTN_CASE(df)                                                                      \
  case df:                                                                                     \
    if (kFloatIO && head_bias.p != nullptr)                                                    \
      return launch_attention_df<TI, TO, df, kFloatIO>(                                        \
          q, q_bs, q_rs, k, v, kv_bs, kv_rs, bias, bias_bs, bias_qs, out, out_bs, out_rs,      \
          batch, heads, sq, sk, scale, smem, stream, head_bias);                               \
    return launch_attention_df<TI, TO, df, false>(                                             \
        q, q_bs, q_rs, k, v, kv_bs, kv_rs, bias, bias_bs, bias_qs, out, out_bs, out_rs, batch, \
        heads, sq, sk, scale, smem, stream, head_bias);
  switch (d / 16) {
    OVQ_ATTN_CASE(1)
    OVQ_ATTN_CASE(2)
    OVQ_ATTN_CASE(3)
    OVQ_ATTN_CASE(4)
    OVQ_ATTN_CASE(5)
    OVQ_ATTN_CASE(6)
    OVQ_ATTN_CASE(7)
    OVQ_ATTN_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef OVQ_ATTN_CASE
}

template cudaError_t launch_attention<float, float>(const float*, long long, int, const float*,
                                                    const float*, long long, int, const float*,
                                                    long long, int, float*, long long, int, int,
                                                    int, int, int, int, float, cudaStream_t,
                                                    HeadBias);

}  // namespace ovq

extern "C" const char* ovq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
