// Streamed packed attention: softmax(scale * Q K^T + bias) V on the raw (b, S,
// heads * d) float32 projections over a key stream of any length, forward only.
//
// Replaces the Pallas kernel `_streamed_kernel` / `_streamed_call`
// (openvivqa_tpu/ops/fused_attention.py:399-450, pallas_call at :483), which the
// JAX package takes where the packed kernel's whole-key blocks no longer fit the
// TPU's VMEM (from 1536 keys at hd 512, from 1024 at hd 768).  Its arithmetic is
// the TPU kernel's, one walk over the keys: f32 logits plus the bias; a running
// max and sum per row; P = exp(logit - running max) rounded to bf16 UNnormalised
// and P V summed in f32; the accumulator rescaled when the max moves and divided
// by the sum (of the f32 P) at the end.  q, k and v are rounded to bf16 as the
// TPU kernel's dot operands are.  A row whose keys are all masked (MASK_VALUE =
// -1e5, never -inf) stays finite: its running max is subtracted before any
// exponent is taken.  Keys past Sk in the last 64-key chunk are masked here.
//
// What bounds it.  At 64 samples x 1536 queries x 1536 keys, hd 512 over 8 heads
// (d 64): 4 b Sq Sk hd = 309 GFLOP, 0.3127 ms of bf16 tensor-core work at 989
// TFLOP/s, against 805 MB of f32 q, k, v and output (0.240 ms at 3.35 TB/s): the
// tensor cores.  The block it replaces (the port's first wmma tile block) read K twice and V once in
// f32 per 64-row query tile, 14.5 GB from L2 in all, and ran at 4.6 % of the bound
// on an H100 (chip_smoke.py phase 3).
//
// The design.
//   1. One cast pass (stream_cast_kernel) rounds K and V to bf16 once, into a
//      head-major (b * heads, Sk, DP) layout padded with zero columns to DP = 64
//      or 128, the rows TMA boxes and wgmma's 128-byte swizzle want; 2 Sk hd f32
//      read and 2 Sk heads DP bf16 written per sample.
//   2. The attention block: one CTA per (192 query rows, head, sample) at a head
//      dim up to 64, per 128 rows up to 128: a producer warpgroup and three (two)
//      consumer warpgroups, the producer giving its registers to the consumers
//      (setmaxnreg).  One producer thread keeps a ring of four stages full with TMA
//      loads of 64-key chunks of K and V (128-byte swizzle, completion on the
//      stage's mbarrier).  Each consumer warpgroup owns 64 query rows: their Q
//      (f32 rounded to bf16, zero past d and past Sq) sits in a shared-memory
//      tile in the K chunks' swizzled layout; S = Q K^T is wgmma m64n64k16 with
//      both operands in shared memory (K the K-major B operand from the ring);
//      the online softmax runs on S's accumulators in registers (a row's 64 keys
//      over the four lanes that hold it); P packed to bf16 is the register A
//      operand of O += P V (wgmma m64nDPk16, V MN-major through the transpose
//      bit), so neither S nor P touches shared memory.  A stage is released when
//      both products have read it; the warpgroups' softmax and products overlap
//      each other's.
//   So every K and V element is read once per 192 query rows, in bf16: 1.6 GB
//   from L2 at this shape instead of 14.5, and Q K^T is computed once.
//   Why Q is not a register operand: held in registers across the key loop as
//   the A operand of every chunk's S, Q's fragments lost their registers once
//   the loop body held one more branch (a choice to load a row-shared bias
//   once).  The PTX defined them once before the loop and never wrote them in
//   it; ptxas (CUDA 12.9) gave those registers to the loop's scratch and packed
//   P into them, which the next chunk's S then read as Q, so every stream of
//   more than one chunk came out wrong.  A register operand here now lives one
//   chunk only (P: packed, read by the P V products, waited for), and
//   chip_smoke.py checks the SASS of every wgmma kernel for operand writes
//   inside a product's window.
//   A cluster of CTAs on neighbouring query tiles sharing each chunk by TMA
//   multicast would halve that again; it is not done here.
#include <stdint.h>

#include "common.cuh"

namespace ovq {
namespace {

constexpr int kChunk = 64;  // keys of one ring stage
constexpr int kStages = 4;

// DP: the padded head dim (64 or 128); consumer warpgroups of 64 query rows, three
// where the 64-column state leaves them the registers (a third one made the block
// faster at 64 x 1536 on an H100), two at 128 columns
template <int DP>
struct StreamTile {
  static constexpr int kConsumers = DP == 64 ? 3 : 2;
  static constexpr int kQRows = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // registers a thread: the producer warpgroup's, then each consumer's
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = DP == 64 ? 152 : 232;
  static constexpr int kBoxes = DP / 64;                 // 64-column TMA boxes of a row
  static constexpr int kBlock = kBoxes * kChunk * 128;  // bytes of one K (or V) chunk
  static constexpr int kStage = 2 * kBlock;
  static constexpr int kQTile = kBoxes * 64 * 128;      // one consumer's 64 query rows, bf16
  static constexpr int kSmem = 1024 + kStages * kStage + kConsumers * kQTile + 2 * kStages * 8;
  static_assert(kSmem <= kMaxSmem, "the ring does not fit");
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
                "the register file");
};

struct StreamArgs {
  const float* q;     // (b, sq, hd)
  float* out;         // (b, sq, hd)
  const float* bias;  // bias + b * bias_bs + i * bias_qs + j, or null
  long long bias_bs;
  int bias_qs;
  int sq, sk, hd, heads, d;
  float scale;
};

// (b * heads, s, dp) bf16 rows, zero past d, from (b, s, heads * d) f32: K then V
__global__ void __launch_bounds__(256)
    stream_cast_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       bf16* __restrict__ out, int s, int heads, int d, int dp,
                       long long quads_per_tensor) {
  const int hd = heads * d, qpr = dp / 4;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < 2 * quads_per_tensor;
       q += (long long)gridDim.x * blockDim.x) {
    const bool is_v = q >= quads_per_tensor;
    const long long e = is_v ? q - quads_per_tensor : q;
    const int c = (int)(e % qpr) * 4;
    const long long row = e / qpr;  // (b * heads + h) * s + i
    const int i = (int)(row % s);
    const long long bh = row / s;
    const int h = (int)(bh % heads);
    const long long b = bh / heads;
    uint2 packed = make_uint2(0u, 0u);
    if (c < d) {
      const float4 x = __ldg(reinterpret_cast<const float4*>((is_v ? v : k) + (b * s + i) * hd +
                                                             (long long)h * d + c));
      packed = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }
    reinterpret_cast<uint2*>(out + (is_v ? quads_per_tensor * 4 : 0))[e] = packed;
  }
}

template <int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2], const unsigned (&a)[4],
                                           uint64_t desc) {
  if constexpr (DP == 128)
    wgmma_m64n128k16_rs(o, a, desc);
  else
    wgmma_m64n64k16_rs(o, a, desc);
}

template <int DP>
__global__ void __launch_bounds__(StreamTile<DP>::kThreads, 1)
    streamed_attention_kernel(const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, const StreamArgs a) {
  using T = StreamTile<DP>;
  constexpr int DF = DP / 16;  // k16 steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_tiles = smem + kStages * T::kStage;  // 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(q_tiles + T::kConsumers * T::kQTile);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int chunks = (a.sk + kChunk - 1) / kChunk;
  const int row0 = (b * a.heads + h) * a.sk;  // this (sample, head)'s first key row
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * T::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // the producer warpgroup: one thread keeps the ring full
    regs_dealloc<T::kProducerRegs>();
    if (tid == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % kStages;
        mbar_wait(&empty[s], ((c / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::kStage);
        unsigned char* kd = smem + s * T::kStage;
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load_2d(kd + x * kChunk * 128, &k_map, &full[s], 64 * x, row0 + c * kChunk);
          tma_load_2d(kd + T::kBlock + x * kChunk * 128, &v_map, &full[s], 64 * x,
                      row0 + c * kChunk);
        }
      }
    }
    return;
  }

  regs_alloc<T::kConsumerRegs>();
  const int wg = tid / 128 - 1, w = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * T::kQRows + wg * 64 + w * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < a.sq, ok1 = r1 < a.sq;
  // this warpgroup's 64 query rows, rounded to bf16 (zero past d and past Sq), into
  // its Q tile in the layout the TMA writes K in: 64-column boxes of 128-byte rows,
  // each row's 16-byte chunks swizzled by the row's place in its group of 8
  unsigned char* qs = q_tiles + wg * T::kQTile;
  for (int idx = tid % 128; idx < 64 * DP / 8; idx += 128) {
    const int i = idx / (DP / 8), c = idx % (DP / 8);
    const int row = blockIdx.x * T::kQRows + wg * 64 + i;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.sq && 8 * c < a.d) {  // d is a multiple of 16
      const float4* src = reinterpret_cast<const float4*>(
          a.q + ((long long)b * a.sq + row) * a.hd + h * a.d + 8 * c);
      const float4 x = __ldg(src), y = __ldg(src + 1);
      packed = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                          pack_bf16(y.z, y.w));
    }
    *reinterpret_cast<uint4*>(qs + (c / 8) * 64 * 128 + i * 128 + (((c % 8) ^ (i % 8)) * 16)) =
        packed;
  }
  fence_async_shared();  // the products read the tile through the async proxy
  named_barrier(1 + wg, 128);
  const float* b0 = a.bias == nullptr ? nullptr
                                      : a.bias + b * a.bias_bs + (long long)(ok0 ? r0 : 0) * a.bias_qs;
  const float* b1 = a.bias == nullptr ? nullptr
                                      : a.bias + b * a.bias_bs + (long long)(ok1 ? r1 : 0) * a.bias_qs;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    const unsigned char* ks = smem + s * T::kStage;
    const unsigned char* vs = ks + T::kBlock;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_operands(sc);  // zeroed before the products start
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DF; ++kk)
      wgmma_m64n64k16<0>(sc, sw128_desc(qs + (kk / 4) * 64 * 128 + 32 * (kk % 4), 16, 1024),
                         sw128_desc(ks + (kk / 4) * kChunk * 128 + 32 * (kk % 4), 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    // logits of this thread's keys 64 c + 8 jj + 2 t (+1) in rows r0 (sc[4 jj], +1)
    // and r1 (sc[4 jj + 2], +3); past Sk -inf
    const int key0 = c * kChunk + 2 * t;
    float cmax0 = -INFINITY, cmax1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * jj + e;
        const bool valid = key < a.sk;
        const float bias0 = b0 == nullptr || !valid ? 0.0f : __ldg(b0 + key);
        const float bias1 = b1 == nullptr || !valid ? 0.0f : __ldg(b1 + key);
        sc[4 * jj + e] = valid ? sc[4 * jj + e] * a.scale + bias0 : -INFINITY;
        sc[4 * jj + 2 + e] = valid ? sc[4 * jj + 2 + e] * a.scale + bias1 : -INFINITY;
        cmax0 = fmaxf(cmax0, sc[4 * jj + e]);
        cmax1 = fmaxf(cmax1, sc[4 * jj + 2 + e]);
      }
    }
    cmax0 = fmaxf(cmax0, __shfl_xor_sync(0xffffffffu, cmax0, 1));
    cmax0 = fmaxf(cmax0, __shfl_xor_sync(0xffffffffu, cmax0, 2));
    cmax1 = fmaxf(cmax1, __shfl_xor_sync(0xffffffffu, cmax1, 1));
    cmax1 = fmaxf(cmax1, __shfl_xor_sync(0xffffffffu, cmax1, 2));
    const float n0 = fmaxf(m0, cmax0), n1 = fmaxf(m1, cmax1);
    const float alpha0 = ex2(m0 - n0), alpha1 = ex2(m1 - n1);  // 0 on the first chunk
    m0 = n0;
    m1 = n1;
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * jj + e] = ex2(sc[4 * jj + e] - n0);
        sc[4 * jj + 2 + e] = ex2(sc[4 * jj + 2 + e] - n1);
        p0 += sc[4 * jj + e];
        p1 += sc[4 * jj + 2 + e];
      }
    }
    l0 = l0 * alpha0 + p0;  // this thread's share of the row's sum
    l1 = l1 * alpha1 + p1;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      o[4 * jj] *= alpha0;
      o[4 * jj + 1] *= alpha0;
      o[4 * jj + 2] *= alpha1;
      o[4 * jj + 3] *= alpha1;
    }
    // P (bf16, unnormalised) as the A operand of 16 keys at a time
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      fence_operands(pa[kk]);
    }
    fence_operands(o);  // rescaled before the products start
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pv_product<DP>(o, pa[kk], sw128_desc(vs + 2048 * kk, kChunk * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    // the products read their register operands until they complete: the
    // compiler must not hand P's registers to anything else before the wait
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
    mbar_arrive(&empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  float* out0 = a.out + ((long long)b * a.sq + r0) * a.hd + h * a.d + 2 * t;
  float* out1 = out0 + 8LL * a.hd;
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    if (8 * jj >= a.d) break;
    if (ok0) *reinterpret_cast<float2*>(out0 + 8 * jj) = make_float2(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
    if (ok1)
      *reinterpret_cast<float2*>(out1 + 8 * jj) = make_float2(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
  }
}

template <int DP>
cudaError_t launch_streamed(const CUtensorMap& k_map, const CUtensorMap& v_map,
                            const StreamArgs& args, int batch, cudaStream_t stream) {
  using T = StreamTile<DP>;
  static const cudaError_t attribute = cudaFuncSetAttribute(
      streamed_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attribute != cudaSuccess) return attribute;
  const dim3 grid((args.sq + T::kQRows - 1) / T::kQRows, args.heads, batch);
  streamed_attention_kernel<DP><<<grid, T::kThreads, T::kSmem, stream>>>(k_map, v_map, args);
  return cudaGetLastError();
}

// the caller's plan (q_rows, stages, chunk, dp, smem) is this instance's own
template <int DP>
bool plan_is(int q_rows, int stages, int chunk, int smem) {
  using T = StreamTile<DP>;
  return q_rows == T::kQRows && stages == kStages && chunk == kChunk && smem == T::kSmem;
}

}  // namespace
}  // namespace ovq

// kv: the bf16 workspace of 2 * batch * heads * sk * dp elements (dp = 64 for a head
// dim up to 64, else 128); q_rows, stages, chunk, dp and smem: the plan of
// ops/fused_attention.py::streamed_plan, refused unless it is the kernel's own
extern "C" int ovq_streamed_attention_forward(const float* q, const float* k, const float* v,
                                              const float* bias, long long bias_bs, int bias_qs,
                                              float* out, ovq::bf16* kv, int batch, int sq,
                                              int sk, int hd, int heads, int q_rows, int stages,
                                              int chunk, int plan_dp, int smem, float scale,
                                              cudaStream_t stream) {
  if (batch <= 0 || sq <= 0) return cudaSuccess;
  if (sk <= 0 || heads <= 0 || hd % heads) return cudaErrorInvalidValue;
  const int d = hd / heads;
  if (d % 16 || d > 128 || batch > 65535 || heads > 65535) return cudaErrorInvalidValue;
  const int dp = d <= 64 ? 64 : 128;
  if (plan_dp != dp || !(dp == 64 ? ovq::plan_is<64>(q_rows, stages, chunk, smem)
                                  : ovq::plan_is<128>(q_rows, stages, chunk, smem)))
    return cudaErrorInvalidValue;
  const long long rows = (long long)batch * heads * sk;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long quads = rows * dp / 4;
  const long long blocks = (2 * quads + 255) / 256;
  ovq::stream_cast_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
      k, v, kv, sk, heads, d, dp, quads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap k_map, v_map;
  if (!ovq::bf16_tensor_map(&k_map, kv, (int)rows, dp, ovq::kChunk) ||
      !ovq::bf16_tensor_map(&v_map, kv + rows * dp, (int)rows, dp, ovq::kChunk))
    return cudaErrorInvalidValue;
  const ovq::StreamArgs args{q, out, bias, bias_bs, bias_qs, sq, sk, hd, heads, d, scale};
  return dp == 64 ? ovq::launch_streamed<64>(k_map, v_map, args, batch, stream)
                  : ovq::launch_streamed<128>(k_map, v_map, args, batch, stream);
}
