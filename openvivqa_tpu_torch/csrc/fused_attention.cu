// Packed attention: softmax(scale * Q K^T + bias) V on the raw (b, S, heads * d)
// projections, all heads of a sample in one launch, forward only.
//
// Replaces the Pallas kernel `_packed_kernel` / `fused_attention_packed`
// (openvivqa_tpu/ops/fused_attention.py).  As there, the dot operands are rounded
// to bf16, the logits and the row softmax are f32, each row's max and denominator
// are taken over all its keys before its weights are rounded to bf16, and P V is
// summed in f32.  The bias is (bb, bq, Sk) with bb in {1, b} and bq in {1, Sq},
// read through strides of 0 where it is shared and never broadcast in device
// memory, or absent (a null pointer).
//
// This file holds the packed entry's block for more query rows than
// ops/fused_attention.py's single-query cut-over (fewer go to the flat
// attention's single-query block, which takes packed operands through strides).
// The dropout, two-bias and streamed entries keep common.cu's attention block.
//
// What bounds it.  At the MMT joint encode (64 samples x 8 heads x 215 x 215,
// d 96, per-sample bias) the work is 9.1 GFLOP against 181 MB of f32 q, k, v,
// bias and output: 0.054 ms of bytes at 3.35 TB/s, 0.009 ms of bf16 tensor-core
// operations at 989 TFLOP/s.  mma.sync at a fraction of the card's peak finishes
// the operations inside the byte bound, so wgmma buys nothing here; what costs
// time is reading K and V more than once, round trips of the scores through
// shared memory, uncoalesced bias reads and copies that never overlap the math.
//
// The design.  One block of 8 warps per (sample, head) converts its head's K and
// V slice to bf16 into shared memory once, while it computes, and walks all of
// that head's query rows over it, 16 rows per warp (`resident`: while 2 * Sk * (d
// + 8) * 2 bytes fit two blocks to an SM).  Past that size, one block per (128
// query rows, head, sample) streams K and V through a two-slot ring of 16- or
// 32-key chunks (`ring`).  Either way the copy of the next chunk is issued to registers
// before the current chunk's math and stored to shared memory after it, one
// barrier per chunk.  The products are mma.sync.m16n8k16 bf16 -> f32 through
// inline PTX with ldmatrix operands, so each warp knows where every score lies:
// its 16 x 16 score tiles stay in registers through the bias add (read in the
// accumulator's layout, two keys of two rows per lane), the row max and sum (an
// online pair per lane in the first walk, merged by 4-lane shuffles), exp2 of
// (logit - max) * log2 e, the normalisation, and the packing of the bf16
// weights into the A operand of P V (FlashAttention-2's accumulator-to-operand
// identity).  The first walk takes each row's max and denominator, the second
// recomputes the scores from shared memory and accumulates P V.
#include <stdint.h>

#include "common.cuh"

namespace ovq {
namespace {

constexpr int kPbThreads = 256;
constexpr int kPbWarps = kPbThreads / 32;
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block may take on the H100
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// e^x for x <= 0 as exp2(x * log2 e)
__device__ __forceinline__ float ex2(float x) { return exp2f(x * kLog2e); }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// keys of one copy step: as many as the registers that carry the copy allow
// beside the accumulators without spilling (ptxas -v), halved in the ring, whose
// second walk copies K and V together
__host__ __device__ constexpr int chunk_keys(int df, bool resident) {
  return (df <= 4 ? 64 : 32) / (resident ? 1 : 2);
}

long long packed_block_smem_bytes(int sk, int df, bool resident) {
  const int rows = resident ? round16(sk) : 2 * chunk_keys(df, false);
  return 2LL * rows * (16 * df + 8) * 2;
}

template <int DF, bool RES>
__global__ void __launch_bounds__(kPbThreads, DF <= 6 ? 2 : 1)
    packed_block_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        long long bias_bs, int bias_qs, float* __restrict__ out, int sq, int sk,
                        int hd, float scale) {
  constexpr int d = 16 * DF;
  constexpr int LD = d + 8;            // bf16 row stride in shared memory: ldmatrix without conflicts
  constexpr int KC = chunk_keys(DF, RES);
  constexpr int kQuads = KC * d / 4;   // float4s of one K or V chunk
  constexpr int PT = (kQuads + kPbThreads - 1) / kPbThreads;
  constexpr int NP = RES ? PT : 2 * PT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int skp = round16(sk);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (RES ? skp : 2 * KC) * LD;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float* kb = k + (long long)b * sk * hd + h * d;
  const float* vb = v + (long long)b * sk * hd + h * d;
  const float* bb = bias == nullptr ? nullptr : bias + b * bias_bs;
  const int nc = (sk + KC - 1) / KC;
  const int steps = 2 * nc;  // first walk: K chunks; second walk: V (and, in the ring, K) chunks
  const int n_tiles = (sq + 15) / 16;
  const int rounds = (n_tiles + kPbWarps - 1) / kPbWarps;

  // copy step s: global f32 -> registers (`load`), registers -> bf16 shared (`store`)
  float4 pre[NP];
  auto load = [&](int s) {
    const int c = s < nc ? s : s - nc;
    const bool both = !RES && s >= nc;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int idx = tid + (u % PT) * kPbThreads;
      const int r = idx / (d / 4), c4 = idx % (d / 4), key = c * KC + r;
      const bool from_v = RES ? s >= nc : (both && u >= PT);
      const bool valid = idx < kQuads && key < sk && (u < PT || both);
      const float* src = (from_v ? vb : kb) + (long long)(valid ? key : 0) * hd + 4 * c4;
      pre[u] = valid ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int s) {
    const int c = s < nc ? s : s - nc;
    const bool both = !RES && s >= nc;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int idx = tid + (u % PT) * kPbThreads;
      const int r = idx / (d / 4), c4 = idx % (d / 4);
      const int row = RES ? c * KC + r : (s % 2) * KC + r;
      const bool from_v = RES ? s >= nc : (both && u >= PT);
      if (idx < kQuads && (u < PT || both) && (!RES || row < skp)) {
        const uint2 packed = make_uint2(pack_bf16(pre[u].x, pre[u].y), pack_bf16(pre[u].z, pre[u].w));
        *reinterpret_cast<uint2*>((from_v ? Vs : Ks) + row * LD + 4 * c4) = packed;
      }
    }
  };

  bool filled = false;
#pragma unroll 1
  for (int round = blockIdx.x; round < rounds; round += gridDim.x) {
    const int tile = round * kPbWarps + warp;
    const bool active = tile < n_tiles;
    const int r0 = tile * 16 + g, r1 = r0 + 8;  // this lane's two rows
    // Q fragments (A operand, bf16), zero past the last row
    unsigned qa[DF][4];
    {
      const float* q0 = q + ((long long)b * sq + (r0 < sq ? r0 : 0)) * hd + h * d + 2 * t;
      const float* q1 = q + ((long long)b * sq + (r1 < sq ? r1 : 0)) * hd + h * d + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DF; ++kk) {
        const float2 z = make_float2(0.f, 0.f);
        const float2 a0 = active && r0 < sq ? *reinterpret_cast<const float2*>(q0 + 16 * kk) : z;
        const float2 a1 = active && r1 < sq ? *reinterpret_cast<const float2*>(q1 + 16 * kk) : z;
        const float2 a2 = active && r0 < sq ? *reinterpret_cast<const float2*>(q0 + 16 * kk + 8) : z;
        const float2 a3 = active && r1 < sq ? *reinterpret_cast<const float2*>(q1 + 16 * kk + 8) : z;
        qa[kk][0] = pack_bf16(a0.x, a0.y);
        qa[kk][1] = pack_bf16(a1.x, a1.y);
        qa[kk][2] = pack_bf16(a2.x, a2.y);
        qa[kk][3] = pack_bf16(a3.x, a3.y);
      }
    }
    const float* b0 = bb == nullptr ? nullptr : bb + (long long)(r0 < sq ? r0 : sq - 1) * bias_qs;
    const float* b1 = bb == nullptr ? nullptr : bb + (long long)(r1 < sq ? r1 : sq - 1) * bias_qs;
    // per lane: running (max, sum) of its keys of rows r0 and r1
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float o[2 * DF][4];
#pragma unroll
    for (int n = 0; n < 2 * DF; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

    // the logits of 16 keys from shared-memory row `srow` (key `key0`): tile
    // s[0] keys key0 + 2t, +1 and s[1] keys key0 + 8 + 2t, +1, rows r0 (0, 1)
    // and r1 (2, 3), as scale * q . k + bias; -inf past sk.  Exponents are taken
    // as exp2((logit - max) * log2 e), the difference first: near -1e5 (a masked
    // row) a logit scaled by log2 e before it would lose the bits that tell its
    // keys apart.
    auto scores = [&](float (&s)[2][4], int srow, int key0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DF; ++kk) {
        unsigned kf[4];
        ldmatrix_x4(kf, Ks + (srow + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + 16 * kk +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qa[kk], kf[0], kf[1]);
        mma_bf16(s[1], qa[kk], kf[2], kf[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * n + 2 * t + e;
          const bool ok = key < sk;
          const float c0 = b0 == nullptr || !ok ? 0.0f : __ldg(b0 + key);
          const float c1 = b1 == nullptr || !ok ? 0.0f : __ldg(b1 + key);
          s[n][e] = ok ? s[n][e] * scale + c0 : -INFINITY;
          s[n][2 + e] = ok ? s[n][2 + e] * scale + c1 : -INFINITY;
        }
      }
    };

    const bool stream = !RES || !filled;  // uniform over the block
    if (stream) {
      load(0);
      store(0);
      __syncthreads();
    }
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      if (stream && s + 1 < steps) load(s + 1);
      const bool second = s >= nc;
      const int c = second ? s - nc : s;
      const int key_end = min(c * KC + KC, skp);
      const int slot_row = RES ? 0 : (s % 2) * KC - c * KC;  // shared row of key j: j + slot_row
      if (active) {
#pragma unroll 1
        for (int key0 = c * KC; key0 < key_end; key0 += 16) {
          float sc[2][4];
          scores(sc, key0 + slot_row, key0);
          if (!second) {
            const float x0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
            const float x1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
            const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
            const float z0 = n0 == -INFINITY ? 0.0f : n0, z1 = n1 == -INFINITY ? 0.0f : n1;
            l0 = l0 * ex2(m0 - z0) + ex2(sc[0][0] - z0) + ex2(sc[0][1] - z0) +
                 ex2(sc[1][0] - z0) + ex2(sc[1][1] - z0);
            l1 = l1 * ex2(m1 - z1) + ex2(sc[0][2] - z1) + ex2(sc[0][3] - z1) +
                 ex2(sc[1][2] - z1) + ex2(sc[1][3] - z1);
            m0 = n0;
            m1 = n1;
            continue;
          }
          // normalised weights, rounded to bf16, as the A operand of P V
          unsigned pa[4];
          pa[0] = pack_bf16(ex2(sc[0][0] - m0) * l0, ex2(sc[0][1] - m0) * l0);
          pa[1] = pack_bf16(ex2(sc[0][2] - m1) * l1, ex2(sc[0][3] - m1) * l1);
          pa[2] = pack_bf16(ex2(sc[1][0] - m0) * l0, ex2(sc[1][1] - m0) * l0);
          pa[3] = pack_bf16(ex2(sc[1][2] - m1) * l1, ex2(sc[1][3] - m1) * l1);
          const int vrow = key0 + slot_row;
#pragma unroll
          for (int n = 0; n < 2 * DF; n += 2) {
            unsigned vf[4];
            ldmatrix_x4_trans(vf, Vs + (vrow + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * n +
                                      ((lane >> 4) & 1) * 8);
            mma_bf16(o[n], pa, vf[0], vf[1]);
            mma_bf16(o[n + 1], pa, vf[2], vf[3]);
          }
        }
      }
      if (s == nc - 1) {
        // merge the four lanes of each row: its max and denominator over all keys;
        // from here on l0, l1 hold the reciprocals of the denominators
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          const float om0 = __shfl_xor_sync(0xffffffffu, m0, x);
          const float om1 = __shfl_xor_sync(0xffffffffu, m1, x);
          const float ol0 = __shfl_xor_sync(0xffffffffu, l0, x);
          const float ol1 = __shfl_xor_sync(0xffffffffu, l1, x);
          const float n0 = fmaxf(m0, om0), n1 = fmaxf(m1, om1);
          const float z0 = n0 == -INFINITY ? 0.0f : n0, z1 = n1 == -INFINITY ? 0.0f : n1;
          l0 = l0 * ex2(m0 - z0) + ol0 * ex2(om0 - z0);
          l1 = l1 * ex2(m1 - z1) + ol1 * ex2(om1 - z1);
          m0 = n0;
          m1 = n1;
        }
        l0 = 1.0f / l0;
        l1 = 1.0f / l1;
      }
      if (stream) {
        if (s + 1 < steps) store(s + 1);
        __syncthreads();
      }
    }
    filled = true;

    if (active) {
      float* o0 = out + ((long long)b * sq + r0) * hd + h * d + 2 * t;
      float* o1 = out + ((long long)b * sq + r1) * hd + h * d + 2 * t;
#pragma unroll
      for (int n = 0; n < 2 * DF; ++n) {
        if (r0 < sq) *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(o[n][0], o[n][1]);
        if (r1 < sq) *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(o[n][2], o[n][3]);
      }
    }
  }
}

template <int DF, bool RES>
cudaError_t launch_packed_block(const float* q, const float* k, const float* v, const float* bias,
                                long long bias_bs, int bias_qs, float* out, int batch, int heads,
                                int sq, int sk, int hd, float scale, cudaStream_t stream) {
  // the attribute is a ceiling, set once per instance; each launch asks for its own size
  static const cudaError_t attribute = cudaFuncSetAttribute(
      packed_block_kernel<DF, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attribute != cudaSuccess) return attribute;
  const long long smem = packed_block_smem_bytes(sk, DF, RES);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int rounds = ((sq + 15) / 16 + kPbWarps - 1) / kPbWarps;
  // resident: one block per (sample, head) walks every round, unless too few
  // (sample, head) pairs would fill two blocks on each of the 132 SMs
  const int pairs = batch * heads;
  const int split = RES ? (2 * 132 + pairs - 1) / pairs : rounds;
  const dim3 grid(rounds < split ? rounds : split, heads, batch);
  packed_block_kernel<DF, RES><<<grid, kPbThreads, smem, stream>>>(q, k, v, bias, bias_bs,
                                                                   bias_qs, out, sq, sk, hd, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ovq

extern "C" int ovq_packed_attention_forward(const float* q, const float* k, const float* v,
                                            const float* bias, long long bias_bs, int bias_qs,
                                            float* out, int batch, int sq, int sk, int hd,
                                            int heads, float scale, int resident,
                                            cudaStream_t stream) {
  using namespace ovq;
  if (batch <= 0 || sq <= 0) return cudaSuccess;
  if (heads <= 0 || hd % heads || sk <= 0 || heads > 65535 || batch > 65535 || hd % 4)
    return cudaErrorInvalidValue;
  const int d = hd / heads;
  if (d % 16 || d > 128 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
#define OVQ_PB_CASE(df)                                                                        \
  case df:                                                                                     \
    return resident ? launch_packed_block<df, true>(q, k, v, bias, bias_bs, bias_qs, out,      \
                                                     batch, heads, sq, sk, hd, scale, stream)  \
                    : launch_packed_block<df, false>(q, k, v, bias, bias_bs, bias_qs, out,     \
                                                      batch, heads, sq, sk, hd, scale, stream);
  switch (d / 16) {
    OVQ_PB_CASE(1)
    OVQ_PB_CASE(2)
    OVQ_PB_CASE(3)
    OVQ_PB_CASE(4)
    OVQ_PB_CASE(5)
    OVQ_PB_CASE(6)
    OVQ_PB_CASE(7)
    OVQ_PB_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef OVQ_PB_CASE
}
