// The backward of the packed attention with in-kernel dropout on the attention
// weights, out = bf16(keep * softmax(scale * Q K^T + bias) / (1 - rate)) V per
// head, on the raw (b, S, heads * d) projections and the upstream gradient G.
//
// Replaces the Pallas kernel `_packed_dropout_bwd_kernel`
// (openvivqa_tpu/ops/fused_attention.py, fused_attention_packed_dropout's
// backward).  As there: bf16 q, k, v and g operands, f32 logits, the weights p
// from the forward's row max and denominator, D_i = sum_j p_ij keep_ij dP_ij
// with dP = G V^T, dS = p (keep dP - D) rounded to bf16, dv = bf16(p keep)^T G,
// dq = dS K scale, dk = dS^T Q scale.  The forward (block B's DROP instance,
// fused_attention.cu) leaves each row's (max, 1 / denominator) in `stats` and the
// Philox keep mask as bits, 32 keys to an int32 word; these kernels read the bits
// and draw no Philox.
//
// What bounds it.  At the MMT training shape (64 samples x 8 heads x 215 x 215,
// d 96, per-sample bias) the five products are 22.7 GFLOP, 0.023 ms at the bf16
// peak, against ~300 MB of f32 q, k, v, g, bias and gradients, 0.09 ms at 3.35
// TB/s.  Re-reads of K, V, Q and G, round trips of scores through shared memory,
// barriers and integer work are what cost time, so the design is block B's.
//
// The design.  On the TPU the backward carried dk and dv across a sequential grid
// axis; blocks on the card run in no order, so it is two kernels, without
// atomics (deterministic), each of 8 warps per (sample, head):
//   * kernel 1, dq and D: K and V converted to bf16 into shared memory once, while
//     the first walk computes (`resident`), or past attention_block's resident
//     limit streamed through a two-slot ring of 16- or 32-key chunks in both
//     walks (`ring`).  Each warp owns 16 query rows and holds their Q and G as
//     mma A fragments.  Walk 1 computes S = Q K^T and dP = G V^T in registers,
//     p from the stats and the bias, and each lane's part of D, merged over the
//     row's four lanes by shuffles.  Walk 2 recomputes S and dP, forms dS in the
//     accumulator layout, packs it to bf16 straight into the A operand of dS K
//     (the accumulator-to-operand identity) and takes K through ldmatrix.trans.
//   * kernel 2, dk and dv: Q and G resident (or in the ring), each row's (max, 1 /
//     denominator, D) in shared memory.  Each warp owns 16 keys and holds their K
//     and V as A fragments; one walk over the queries computes S^T = K Q^T and
//     dP^T = V G^T in registers and adds bf16(p keep)^T G to dv and bf16(dS)^T Q
//     to dk.  The per-row bias is a column walk here, read in the accumulator
//     layout with __ldg (a 16 x 16 tile touches 16 rows of 64 bytes).
// Scores, p, keep and dS line up element for element in registers, so no score
// goes through shared memory.  Where too few (sample, head) pairs would leave
// SMs idle, the rows (kernel 1) or the keys (kernel 2) are split over more
// blocks, as block B splits its rows.
#include <stdint.h>

#include "common.cuh"

namespace ovq {
namespace {

// rows of one copy step: each step copies two operands (K and V, or Q and G)
__host__ __device__ constexpr int bwd_chunk(int df) { return df <= 4 ? 32 : 16; }

// The two operands a kernel keeps in shared memory as bf16 (K and V, or Q and
// G): rows [0, n) of two f32 sources (row stride ld), all of them (RES) or a
// two-slot ring of KC-row chunks.  `load` brings chunk c into registers, `store`
// writes it, so a copy overlaps the math of the chunk before it.
template <int DF, bool RES>
struct PairStage {
  static constexpr int d = 16 * DF;
  static constexpr int LD = d + 8;  // bf16 row stride: ldmatrix without bank conflicts
  static constexpr int KC = bwd_chunk(DF);
  static constexpr int kQuads = KC * d / 4;  // float4s of one chunk of one operand
  static constexpr int PT = (kQuads + kMmaThreads - 1) / kMmaThreads;

  const float* a;
  const float* b;
  int n;
  long long ld;
  bf16* As;
  bf16* Bs;
  float4 pre[2 * PT];

  __host__ __device__ static long long rows(int n) { return RES ? round16(n) : 2 * KC; }
  static long long smem_bytes(int n) { return 2 * rows(n) * LD * 2; }

  __device__ __forceinline__ void load(int c) {
#pragma unroll
    for (int u = 0; u < 2 * PT; ++u) {
      const int idx = threadIdx.x + (u % PT) * kMmaThreads;
      const int r = idx / (d / 4), c4 = idx % (d / 4), row = c * KC + r;
      const bool valid = idx < kQuads && row < n;
      const float* src = (u < PT ? a : b) + (long long)(valid ? row : 0) * ld + 4 * c4;
      pre[u] = valid ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(int c, int slot) {
#pragma unroll
    for (int u = 0; u < 2 * PT; ++u) {
      const int idx = threadIdx.x + (u % PT) * kMmaThreads;
      const int r = idx / (d / 4), c4 = idx % (d / 4);
      const int row = RES ? c * KC + r : slot * KC + r;
      if (idx < kQuads && (!RES || row < round16(n))) {
        const uint2 packed = make_uint2(pack_bf16(pre[u].x, pre[u].y), pack_bf16(pre[u].z, pre[u].w));
        *reinterpret_cast<uint2*>((u < PT ? As : Bs) + row * LD + 4 * c4) = packed;
      }
    }
  }
};

// blocks of a launch: one per (sample, head) walks every round of 16-row tiles
// while RES, unless too few pairs would fill `per_sm` blocks on each of the 132
// SMs; in the ring one block per round
int bwd_split(int rounds, int pairs, bool resident, int per_sm) {
  const int split = resident ? (per_sm * 132 + pairs - 1) / pairs : rounds;
  return rounds < split ? rounds : split;
}

// -- kernel 1: dq and the row terms D ---------------------------------------------------
template <int DF, bool RES>
__global__ void __launch_bounds__(kMmaThreads, DF <= 4 ? 2 : 1)
    dropout_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ bias, long long bias_bs, int bias_qs,
                      const float2* __restrict__ stats, const unsigned* __restrict__ bits,
                      float keep_scale, float* __restrict__ delta, float* __restrict__ dq, int sq,
                      int sk, int hd, float scale) {
  using Stage = PairStage<DF, RES>;
  constexpr int d = Stage::d, LD = Stage::LD, KC = Stage::KC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int skp = round16(sk);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Stage::rows(sk) * LD;

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  const long long row_base = ((long long)b * gridDim.y + h) * sq;
  const int n_words = (sk + 31) / 32;
  const float* bb = bias == nullptr ? nullptr : bias + b * bias_bs;
  const long long head = (long long)b * sq * hd + h * d;
  const long long kv_head = (long long)b * sk * hd + h * d;
  Stage stage{k + kv_head, v + kv_head, sk, hd, Ks, Vs};
  const int nc = (sk + KC - 1) / KC;
  const int steps = 2 * nc;  // walk 1: D; walk 2: dS and dq
  const int n_tiles = (sq + 15) / 16;
  const int rounds = (n_tiles + kMmaWarps - 1) / kMmaWarps;

  bool filled = false;
#pragma unroll 1
  for (int round = blockIdx.x; round < rounds; round += gridDim.x) {
    const int tile = round * kMmaWarps + warp;
    const bool active = tile < n_tiles;
    const int r0 = tile * 16 + gr, r1 = r0 + 8;  // this lane's two rows
    unsigned qa[DF][4], ga[DF][4];
    load_a_rows<DF>(qa, q + head, r0, sq, hd, t, active);
    load_a_rows<DF>(ga, g + head, r0, sq, hd, t, active);
    const int c0 = r0 < sq ? r0 : sq - 1, c1 = r1 < sq ? r1 : sq - 1;  // clamped rows
    const float2 st0 = stats[row_base + c0], st1 = stats[row_base + c1];  // (max, 1 / sum)
    const unsigned* mk0 = bits + (row_base + c0) * n_words;
    const unsigned* mk1 = bits + (row_base + c1) * n_words;
    const float* b0 = bb == nullptr ? nullptr : bb + (long long)c0 * bias_qs;
    const float* b1 = bb == nullptr ? nullptr : bb + (long long)c1 * bias_qs;
    float d0 = 0.0f, d1 = 0.0f;  // D of rows r0, r1: this lane's keys, then the row's
    float o[2 * DF][4];
#pragma unroll
    for (int n = 0; n < 2 * DF; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

    const bool stream = !RES || !filled;  // uniform over the block
    auto copies = [&](int s) { return stream && s < (RES ? nc : steps); };
    if (copies(0)) {
      stage.load(0);
      stage.store(0, 0);
      __syncthreads();
    }
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      if (copies(s + 1)) stage.load((s + 1) % nc);
      const bool second = s >= nc;
      const int c = second ? s - nc : s;
      const int key_end = min(c * KC + KC, skp);
      const int slot_row = RES ? 0 : (s % 2) * KC - c * KC;  // shared row of key j: j + slot_row
      if (active) {
#pragma unroll 1
        for (int key0 = c * KC; key0 < key_end; key0 += 16) {
          float sc[2][4], dp[2][4], ds[2][4];
          times_rows_t<DF, LD>(sc, qa, Ks, key0 + slot_row, lane);
          times_rows_t<DF, LD>(dp, ga, Vs, key0 + slot_row, lane);
          // bit j: key key0 + j's keep
          const unsigned w0 = __ldg(mk0 + key0 / 32) >> (key0 & 16);
          const unsigned w1 = __ldg(mk1 + key0 / 32) >> (key0 & 16);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int bit = 8 * n + 2 * t + e, key = key0 + bit;
              const bool ok = key < sk;
              const float bias0 = b0 == nullptr || !ok ? 0.0f : __ldg(b0 + key);
              const float bias1 = b1 == nullptr || !ok ? 0.0f : __ldg(b1 + key);
              const float x0 = sc[n][e] * scale + bias0, x1 = sc[n][2 + e] * scale + bias1;
              const float p0 = ok ? ex2(x0 - st0.x) * st0.y : 0.0f;
              const float p1 = ok ? ex2(x1 - st1.x) * st1.y : 0.0f;
              const float f0 = (w0 >> bit) & 1u ? keep_scale : 0.0f;
              const float f1 = (w1 >> bit) & 1u ? keep_scale : 0.0f;
              if (!second) {
                d0 += p0 * f0 * dp[n][e];
                d1 += p1 * f1 * dp[n][2 + e];
              } else {
                ds[n][e] = p0 * (f0 * dp[n][e] - d0);
                ds[n][2 + e] = p1 * (f1 * dp[n][2 + e] - d1);
              }
            }
          }
          if (second) {
            unsigned da[4];
            pack_a(da, ds);
            add_times_rows<DF, LD>(o, da, Ks, key0 + slot_row, lane);
          }
        }
      }
      if (s == nc - 1) {
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, x);
          d1 += __shfl_xor_sync(0xffffffffu, d1, x);
        }
      }
      if (copies(s + 1)) {
        stage.store((s + 1) % nc, (s + 1) % 2);
        __syncthreads();
      }
    }
    filled = true;

    if (active) {
      store_acc_rows<DF>(o, dq + head, r0, sq, hd, t, scale);
      if (t == 0 && r0 < sq) delta[row_base + r0] = d0;
      if (t == 1 && r1 < sq) delta[row_base + r1] = d1;
    }
  }
}

// -- kernel 2: dk and dv ----------------------------------------------------------------
template <int DF, bool RES>
long long dkdv_smem_bytes(int sq) {
  return PairStage<DF, RES>::smem_bytes(sq) + 16LL * round16(sq);
}

template <int DF, bool RES>
__global__ void __launch_bounds__(kMmaThreads, DF <= 2 ? 2 : 1)
    dropout_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ bias, long long bias_bs, int bias_qs,
                        const float2* __restrict__ stats, const unsigned* __restrict__ bits,
                        const float* __restrict__ delta, float keep_scale, float* __restrict__ dk,
                        float* __restrict__ dv, int sq, int sk, int hd, float scale) {
  using Stage = PairStage<DF, RES>;
  constexpr int d = Stage::d, LD = Stage::LD, KC = Stage::KC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sqp = round16(sq);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + Stage::rows(sq) * LD;
  float4* rows = reinterpret_cast<float4*>(Gs + Stage::rows(sq) * LD);  // (max, 1 / sum, D, -)

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  const long long row_base = ((long long)b * gridDim.y + h) * sq;
  const int n_words = (sk + 31) / 32;
  const float* bb = bias == nullptr ? nullptr : bias + b * bias_bs;
  const long long head = (long long)b * sk * hd + h * d;
  Stage stage{q + (long long)b * sq * hd + h * d, g + (long long)b * sq * hd + h * d, sq, hd,
              Qs, Gs};
  const int nc = (sq + KC - 1) / KC;
  const int n_tiles = (sk + 15) / 16;
  const int rounds = (n_tiles + kMmaWarps - 1) / kMmaWarps;
  // rows past sq get weight 0: exp2(x - inf) * 0
  for (int i = threadIdx.x; i < sqp; i += kMmaThreads) {
    const float2 st = i < sq ? stats[row_base + i] : make_float2(INFINITY, 0.0f);
    rows[i] = make_float4(st.x, st.y, i < sq ? delta[row_base + i] : 0.0f, 0.0f);
  }

  bool filled = false;
#pragma unroll 1
  for (int round = blockIdx.x; round < rounds; round += gridDim.x) {
    const int tile = round * kMmaWarps + warp;
    const bool active = tile < n_tiles;
    const int j0 = tile * 16 + gr, j1 = j0 + 8;  // this lane's two keys
    const bool ok0 = j0 < sk, ok1 = j1 < sk;
    unsigned ka[DF][4], va[DF][4];
    load_a_rows<DF>(ka, k + head, j0, sk, hd, t, active);
    load_a_rows<DF>(va, v + head, j0, sk, hd, t, active);
    const float* b0 = bb == nullptr ? nullptr : bb + (ok0 ? j0 : sk - 1);
    const float* b1 = bb == nullptr ? nullptr : bb + (ok1 ? j1 : sk - 1);
    // the word of keys j0 and j1 in each row, and their bits in it
    const unsigned* mk = bits + row_base * n_words + tile / 2;
    const int bit0 = (tile & 1) * 16 + gr, bit1 = bit0 + 8;
    float dko[2 * DF][4], dvo[2 * DF][4];
#pragma unroll
    for (int n = 0; n < 2 * DF; ++n) {
      dko[n][0] = dko[n][1] = dko[n][2] = dko[n][3] = 0.0f;
      dvo[n][0] = dvo[n][1] = dvo[n][2] = dvo[n][3] = 0.0f;
    }

    const bool stream = !RES || !filled;  // uniform over the block
    auto copies = [&](int s) { return stream && s < nc; };
    if (copies(0)) {
      stage.load(0);
      stage.store(0, 0);
      __syncthreads();
    }
#pragma unroll 1
    for (int s = 0; s < nc; ++s) {
      if (copies(s + 1)) stage.load(s + 1);
      const int row_end = min(s * KC + KC, sqp);
      const int slot_row = RES ? 0 : (s % 2) * KC - s * KC;  // shared row of query i: i + slot_row
      if (active) {
#pragma unroll 1
        for (int i0 = s * KC; i0 < row_end; i0 += 16) {
          float st[2][4], dpt[2][4], pk[2][4], ds[2][4];
          times_rows_t<DF, LD>(st, ka, Qs, i0 + slot_row, lane);
          times_rows_t<DF, LD>(dpt, va, Gs, i0 + slot_row, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = i0 + 8 * n + 2 * t + e;
              const long long ic = i < sq ? i : sq - 1;
              const float4 r = rows[i];
              const unsigned word = __ldg(mk + ic * n_words);
              const float x0 =
                  st[n][e] * scale + (b0 == nullptr ? 0.0f : __ldg(b0 + ic * bias_qs));
              const float x1 =
                  st[n][2 + e] * scale + (b1 == nullptr ? 0.0f : __ldg(b1 + ic * bias_qs));
              const float p0 = ok0 ? ex2(x0 - r.x) * r.y : 0.0f;
              const float p1 = ok1 ? ex2(x1 - r.x) * r.y : 0.0f;
              const float f0 = (word >> bit0) & 1u ? keep_scale : 0.0f;
              const float f1 = (word >> bit1) & 1u ? keep_scale : 0.0f;
              pk[n][e] = p0 * f0;
              pk[n][2 + e] = p1 * f1;
              ds[n][e] = p0 * (f0 * dpt[n][e] - r.z);
              ds[n][2 + e] = p1 * (f1 * dpt[n][2 + e] - r.z);
            }
          }
          unsigned pa[4], da[4];
          pack_a(pa, pk);
          pack_a(da, ds);
          add_times_rows<DF, LD>(dvo, pa, Gs, i0 + slot_row, lane);
          add_times_rows<DF, LD>(dko, da, Qs, i0 + slot_row, lane);
        }
      }
      if (copies(s + 1)) {
        stage.store(s + 1, (s + 1) % 2);
        __syncthreads();
      }
    }
    filled = true;

    if (active) {
      store_acc_rows<DF>(dko, dk + head, j0, sk, hd, t, scale);
      store_acc_rows<DF>(dvo, dv + head, j0, sk, hd, t, 1.0f);
    }
  }
}

template <int DF, bool KV_RES, bool QG_RES>
cudaError_t launch_backward(const float* q, const float* k, const float* v, const float* g,
                            const float* bias, long long bias_bs, int bias_qs, const float2* stats,
                            const unsigned* bits, float keep_scale, float* delta, float* dq,
                            float* dk, float* dv, int batch, int sq, int sk, int hd, int heads,
                            float scale, cudaStream_t stream) {
  // the attributes are ceilings, set once per instance; each launch asks for its own size
  static const cudaError_t attribute_dq = cudaFuncSetAttribute(
      dropout_dq_kernel<DF, KV_RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  static const cudaError_t attribute_dkdv = cudaFuncSetAttribute(
      dropout_dkdv_kernel<DF, QG_RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attribute_dq != cudaSuccess) return attribute_dq;
  if (attribute_dkdv != cudaSuccess) return attribute_dkdv;
  const long long smem_dq = PairStage<DF, KV_RES>::smem_bytes(sk);
  const long long smem_dkdv = dkdv_smem_bytes<DF, QG_RES>(sq);
  if (smem_dq > kMaxSmem || smem_dkdv > kMaxSmem) return cudaErrorInvalidValue;
  const int pairs = batch * heads;
  const int q_rounds = ((sq + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  const int k_rounds = ((sk + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  dropout_dq_kernel<DF, KV_RES>
      <<<dim3(bwd_split(q_rounds, pairs, KV_RES, DF <= 4 ? 2 : 1), heads, batch), kMmaThreads,
         smem_dq, stream>>>(q, k, v, g, bias, bias_bs, bias_qs, stats, bits, keep_scale, delta,
                            dq, sq, sk, hd, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dropout_dkdv_kernel<DF, QG_RES>
      <<<dim3(bwd_split(k_rounds, pairs, QG_RES, DF <= 2 ? 2 : 1), heads, batch), kMmaThreads,
         smem_dkdv, stream>>>(q, k, v, g, bias, bias_bs, bias_qs, stats, bits, delta,
                              keep_scale, dk, dv, sq, sk, hd, scale);
  return cudaGetLastError();
}

template <int DF>
cudaError_t launch_backward_df(bool kv_resident, bool qg_resident, const float* q, const float* k,
                               const float* v, const float* g, const float* bias,
                               long long bias_bs, int bias_qs, const float2* stats,
                               const unsigned* bits, float keep_scale, float* delta, float* dq,
                               float* dk, float* dv, int batch, int sq, int sk, int hd, int heads,
                               float scale, cudaStream_t stream) {
#define OVQ_BWD_ARGS                                                                          \
  q, k, v, g, bias, bias_bs, bias_qs, stats, bits, keep_scale, delta, dq, dk, dv, batch, sq, sk, \
      hd, heads, scale, stream
  if (kv_resident)
    return qg_resident ? launch_backward<DF, true, true>(OVQ_BWD_ARGS)
                       : launch_backward<DF, true, false>(OVQ_BWD_ARGS);
  return qg_resident ? launch_backward<DF, false, true>(OVQ_BWD_ARGS)
                     : launch_backward<DF, false, false>(OVQ_BWD_ARGS);
#undef OVQ_BWD_ARGS
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace ovq

// dq, dk, dv of the dropout attention from the forward's `stats` ((b, heads, sq)
// float2 (max, 1 / denominator)) and keep `bits` ((b, heads, sq, ceil(sk / 32))
// int32); `delta` ((b, heads, sq) f32) receives D.  kv_resident / qg_resident
// choose kernel 1's and kernel 2's form (ops/fused_attention.py::attention_block).
extern "C" int ovq_packed_dropout_backward(const float* q, const float* k, const float* v,
                                           const float* g, const float* bias, long long bias_bs,
                                           int bias_qs, float keep_scale, const float* stats,
                                           const int* bits, float* delta, float* dq, float* dk,
                                           float* dv, int batch, int sq, int sk, int hd, int heads,
                                           float scale, int kv_resident, int qg_resident,
                                           cudaStream_t stream) {
  using namespace ovq;
  if (batch <= 0 || sq <= 0) return cudaSuccess;
  if (heads <= 0 || hd % heads || sk <= 0 || heads > 65535 || batch > 65535 || hd % 4 ||
      stats == nullptr || bits == nullptr || delta == nullptr)
    return cudaErrorInvalidValue;
  const int d = hd / heads;
  if (d % 16 || d > 128 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(g) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorInvalidValue;
  const float2* st = reinterpret_cast<const float2*>(stats);
  const unsigned* mask = reinterpret_cast<const unsigned*>(bits);
#define OVQ_BWD_CASE(df)                                                                       \
  case df:                                                                                     \
    return launch_backward_df<df>(kv_resident != 0, qg_resident != 0, q, k, v, g, bias,        \
                                  bias_bs, bias_qs, st, mask, keep_scale, delta, dq, dk, dv,   \
                                  batch, sq, sk, hd, heads, scale, stream);
  switch (d / 16) {
    OVQ_BWD_CASE(1)
    OVQ_BWD_CASE(2)
    OVQ_BWD_CASE(3)
    OVQ_BWD_CASE(4)
    OVQ_BWD_CASE(5)
    OVQ_BWD_CASE(6)
    OVQ_BWD_CASE(7)
    OVQ_BWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef OVQ_BWD_CASE
}
