// Packed attention: softmax(scale * Q K^T + bias) V on the raw (b, S, heads * d)
// projections, all heads of a sample in one launch, forward only; its dropout
// instance, (keep * softmax / (1 - rate)) V; and its two-bias instance,
// softmax(scale * Q K^T + bias + head_bias) V.
//
// Replaces the Pallas kernels `_packed_kernel` / `fused_attention_packed`,
// `_packed_dropout_kernel` / `fused_attention_packed_dropout`'s forward and
// `_packed_2bias_kernel` / `fused_attention_packed_2bias`
// (openvivqa_tpu/ops/fused_attention.py).  As there, the dot operands are rounded
// to bf16, the logits and the row softmax are f32, each row's max and denominator
// are taken over all its keys before its weights are rounded to bf16, and P V is
// summed in f32.  The bias is (bb, bq, Sk) with bb in {1, b} and bq in {1, Sq},
// read through strides of 0 where it is shared and never broadcast in device
// memory, or absent (a null pointer).
//
// This file holds the packed entry's block for more query rows than
// ops/fused_attention.py's single-query cut-over (fewer go to the flat
// attention's single-query block, which takes packed operands through strides),
// the dropout entry's block at every shape, kernel F's attention at every
// shape: a bf16 instance that reads q, k and v from the packed (rows, 3 * hd) q|k|v
// projection through a row stride and writes the bf16 context (TI = TO = bf16),
// and the two-bias entry's block at every shape (HB; the other instances
// compile as before).
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

#include <type_traits>

#include "common.cuh"

namespace ovq {
namespace {

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

// The two-bias instance (HB): a second additive bias with a head axis (T5's
// relative positions, DeBERTa's disentangled terms), added after the head-shared
// one, each lane reading it in the accumulator's layout beside that one: element
// (b, h, i, j) at p + b * bs + h * hs + i * qs + j.  A stride of 0 shares it, so
// T5's (1, h, L, L) table is read by every sample, never broadcast in device
// memory.  At the mT5 encoder (60 samples x 6 heads of 64 x 26 question tokens)
// the work is ~9 MB of f32 projections, bias and output against 0.03 GFLOP:
// bytes, and the launch's fixed cost weighs more than either.
struct HeadBias {
  const float* p;
  long long bs;
  long long hs;
  int qs;
};

// The dropout instance (DROP): the counterpart of `_packed_dropout_kernel`.  Each
// row's (max, 1 / denominator) goes to `stats` (b, heads, sq) as the backward
// reads it, and in the second walk each normalised weight is multiplied by its
// keep factor (0 or keep_scale) in registers before it is rounded to bf16.  The
// Philox mask is counted by (key / 4, row, head, sample): of a 16 x 16 tile, lane
// (g, t) holds keys key0 + 2t, +1 and key0 + 8 + 2t, +1 of rows r0 and r1, the
// groups key0 / 4 + t / 2 and that + 2 of both rows, which lane t ^ 1 needs too.
// So each lane draws the two groups of one row (r0 for even t, r1 for odd t),
// one Philox call per four weights, and two shuffles over the row's four lanes
// give every lane both rows' 16 keep bits.  Those bits are also written out, 32
// keys to an int32 word (`bits`, (b, heads, sq, ceil(sk / 32)), keys past sk
// dropped), for the backward kernels, which then draw no Philox at all.
struct DropArgs {
  const long long* seed;
  unsigned threshold;
  float keep_scale;
  float2* stats;
  unsigned* bits;
};

// The A fragments of rows r0 and r1 = r0 + 8 of a bf16 matrix (row stride ld,
// this head's columns from `base`): load_a_rows' layout, read as it is stored
using ::ovq::load_a_rows;  // the f32 rows' version (common.cuh)
template <int DF>
__device__ __forceinline__ void load_a_rows(unsigned (&a)[DF][4], const bf16* base, int r0,
                                            int rows, long long ld, int t, bool active) {
  const int r1 = r0 + 8;
  const bf16* p0 = base + (long long)(r0 < rows ? r0 : 0) * ld + 2 * t;
  const bf16* p1 = base + (long long)(r1 < rows ? r1 : 0) * ld + 2 * t;
  const bool ok0 = active && r0 < rows, ok1 = active && r1 < rows;
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    a[kk][0] = ok0 ? *reinterpret_cast<const unsigned*>(p0 + 16 * kk) : 0u;
    a[kk][1] = ok1 ? *reinterpret_cast<const unsigned*>(p1 + 16 * kk) : 0u;
    a[kk][2] = ok0 ? *reinterpret_cast<const unsigned*>(p0 + 16 * kk + 8) : 0u;
    a[kk][3] = ok1 ? *reinterpret_cast<const unsigned*>(p1 + 16 * kk + 8) : 0u;
  }
}

// four consecutive K or V values as the copy carries them: f32 (converted when
// stored) or bf16 (stored as they are); zeros when !valid
__device__ __forceinline__ float4 load_four(const float* p, bool valid) {
  return valid ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ uint2 load_four(const bf16* p, bool valid) {
  return valid ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
}
__device__ __forceinline__ uint2 four_bf16(float4 v) {
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ uint2 four_bf16(uint2 v) { return v; }

// TI, TO: float (q, k, v and out rows of stride hd) or bf16 (kernel F: q at
// column h * d, k at hd + h * d and v at 2 * hd + h * d of rows of stride in_rs,
// the context out in rows of stride out_rs; in_rs and out_rs are read only then)
template <int DF, bool RES, bool DROP, bool HB, typename TI = float, typename TO = float>
__global__ void __launch_bounds__(kMmaThreads, DF <= 6 ? 2 : 1)
    packed_block_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                        const TI* __restrict__ v, const float* __restrict__ bias,
                        long long bias_bs, int bias_qs, TO* __restrict__ out, int sq, int sk,
                        int hd, float scale, DropArgs drop, int in_rs, int out_rs, HeadBias hb) {
  constexpr bool kBf16 = std::is_same<TI, bf16>::value;
  static_assert(kBf16 == std::is_same<TO, bf16>::value && (!kBf16 || !DROP),
                "bf16 in and out together, without dropout");
  const int rs = kBf16 ? in_rs : hd;
  constexpr int d = 16 * DF;
  constexpr int LD = d + 8;            // bf16 row stride in shared memory: ldmatrix without conflicts
  constexpr int KC = chunk_keys(DF, RES);
  constexpr int kQuads = KC * d / 4;   // float4s of one K or V chunk
  constexpr int PT = (kQuads + kMmaThreads - 1) / kMmaThreads;
  constexpr int NP = RES ? PT : 2 * PT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int skp = round16(sk);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (RES ? skp : 2 * KC) * LD;

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const TI* kb = k + (long long)b * sk * rs + h * d;
  const TI* vb = v + (long long)b * sk * rs + h * d;
  const float* bb = bias == nullptr ? nullptr : bias + b * bias_bs;
  const int nc = (sk + KC - 1) / KC;
  const int steps = 2 * nc;  // first walk: K chunks; second walk: V (and, in the ring, K) chunks
  const int n_tiles = (sq + 15) / 16;
  const int rounds = (n_tiles + kMmaWarps - 1) / kMmaWarps;
  // the dropout's Philox key and this (sample, head)'s first row of stats and bits
  const unsigned long long seed = DROP ? (unsigned long long)*drop.seed : 0ull;
  const long long row_base = ((long long)b * gridDim.y + h) * sq;
  const int n_words = (sk + 31) / 32;

  // copy step s: global f32 -> registers (`load`), registers -> bf16 shared (`store`)
  // (bf16 rows are copied as they are)
  std::conditional_t<kBf16, uint2, float4> pre[NP];
  auto load = [&](int s) {
    const int c = s < nc ? s : s - nc;
    const bool both = !RES && s >= nc;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int idx = tid + (u % PT) * kMmaThreads;
      const int r = idx / (d / 4), c4 = idx % (d / 4), key = c * KC + r;
      const bool from_v = RES ? s >= nc : (both && u >= PT);
      const bool valid = idx < kQuads && key < sk && (u < PT || both);
      const TI* src = (from_v ? vb : kb) + (long long)(valid ? key : 0) * rs + 4 * c4;
      pre[u] = load_four(src, valid);
    }
  };
  auto store = [&](int s) {
    const int c = s < nc ? s : s - nc;
    const bool both = !RES && s >= nc;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int idx = tid + (u % PT) * kMmaThreads;
      const int r = idx / (d / 4), c4 = idx % (d / 4);
      const int row = RES ? c * KC + r : (s % 2) * KC + r;
      const bool from_v = RES ? s >= nc : (both && u >= PT);
      if (idx < kQuads && (u < PT || both) && (!RES || row < skp)) {
        *reinterpret_cast<uint2*>((from_v ? Vs : Ks) + row * LD + 4 * c4) = four_bf16(pre[u]);
      }
    }
  };

  bool filled = false;
#pragma unroll 1
  for (int round = blockIdx.x; round < rounds; round += gridDim.x) {
    const int tile = round * kMmaWarps + warp;
    const bool active = tile < n_tiles;
    const int r0 = tile * 16 + g, r1 = r0 + 8;  // this lane's two rows
    unsigned qa[DF][4];  // Q fragments (A operand, bf16), zero past the last row
    load_a_rows<DF>(qa, q + (long long)b * sq * rs + h * d, tile * 16 + g, sq, rs, t, active);
    const float* b0 = bb == nullptr ? nullptr : bb + (long long)(r0 < sq ? r0 : sq - 1) * bias_qs;
    const float* b1 = bb == nullptr ? nullptr : bb + (long long)(r1 < sq ? r1 : sq - 1) * bias_qs;
    const float* hb_row = HB ? hb.p + b * hb.bs + h * hb.hs : nullptr;
    const float* h0 = HB ? hb_row + (long long)(r0 < sq ? r0 : sq - 1) * hb.qs : nullptr;
    const float* h1 = HB ? hb_row + (long long)(r1 < sq ? r1 : sq - 1) * hb.qs : nullptr;
    // per lane: running (max, sum) of its keys of rows r0 and r1
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float o[2 * DF][4];
#pragma unroll
    for (int n = 0; n < 2 * DF; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    unsigned word0 = 0u, word1 = 0u;  // DROP: the keep bits of rows r0, r1 gathered for `bits`

    // the logits of 16 keys from shared-memory row `srow` (key `key0`): tile
    // s[0] keys key0 + 2t, +1 and s[1] keys key0 + 8 + 2t, +1, rows r0 (0, 1)
    // and r1 (2, 3), as scale * q . k + bias; -inf past sk
    auto scores = [&](float (&s)[2][4], int srow, int key0) {
      times_rows_t<DF, LD>(s, qa, Ks, srow, lane);
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
          if (HB && ok) {
            s[n][e] += __ldg(h0 + key);
            s[n][2 + e] += __ldg(h1 + key);
          }
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
          // normalised weights (DROP: times their keep factors), rounded to
          // bf16, as the A operand of P V
          float w[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              w[n][e] = ex2(sc[n][e] - m0) * l0;
              w[n][2 + e] = ex2(sc[n][2 + e] - m1) * l1;
            }
          }
          if (DROP) {
            const int half = t >> 1;
            const unsigned row = (t & 1) ? r1 : r0;
            const unsigned group = key0 / 4 + half;
            const uint4 lo = philox4x32_10(make_uint4(group, row, h, b), (unsigned)seed,
                                           (unsigned)(seed >> 32));
            const uint4 hi = philox4x32_10(make_uint4(group + 2, row, h, b), (unsigned)seed,
                                           (unsigned)(seed >> 32));
            // bit j of the low half: key key0 + j of row r0; of the high half: of row r1
            unsigned keep = (keep_bits4(lo, drop.threshold) << (4 * half) |
                             keep_bits4(hi, drop.threshold) << (8 + 4 * half))
                            << (16 * (t & 1));
            keep |= __shfl_xor_sync(0xffffffffu, keep, 1);
            keep |= __shfl_xor_sync(0xffffffffu, keep, 2);
            const unsigned valid = sk - key0 >= 16 ? 0xffffu : (1u << (sk - key0)) - 1u;
            keep &= valid | valid << 16;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int bit = 8 * n + 2 * t + e;
                w[n][e] *= (keep >> bit) & 1u ? drop.keep_scale : 0.0f;
                w[n][2 + e] *= (keep >> (16 + bit)) & 1u ? drop.keep_scale : 0.0f;
              }
            }
            word0 |= (keep & 0xffffu) << (key0 & 16);
            word1 |= (keep >> 16) << (key0 & 16);
            if ((key0 & 16) || key0 + 16 >= sk) {  // a word's last 16 keys, or the row's
              const long long word = key0 / 32;
              if (t == 0 && r0 < sq) drop.bits[(row_base + r0) * n_words + word] = word0;
              if (t == 1 && r1 < sq) drop.bits[(row_base + r1) * n_words + word] = word1;
              word0 = word1 = 0u;
            }
          }
          unsigned pa[4];
          pack_a(pa, w);
          add_times_rows<DF, LD>(o, pa, Vs, key0 + slot_row, lane);
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
        if (DROP && active) {
          if (t == 0 && r0 < sq) drop.stats[row_base + r0] = make_float2(m0, l0);
          if (t == 1 && r1 < sq) drop.stats[row_base + r1] = make_float2(m1, l1);
        }
      }
      if (stream) {
        if (s + 1 < steps) store(s + 1);
        __syncthreads();
      }
    }
    filled = true;

    if constexpr (kBf16) {
      if (active) {
        TO* o0 = out + ((long long)b * sq + r0) * out_rs + h * d + 2 * t;
        TO* o1 = out + ((long long)b * sq + r1) * out_rs + h * d + 2 * t;
#pragma unroll
        for (int n = 0; n < 2 * DF; ++n) {
          if (r0 < sq) *reinterpret_cast<unsigned*>(o0 + 8 * n) = pack_bf16(o[n][0], o[n][1]);
          if (r1 < sq) *reinterpret_cast<unsigned*>(o1 + 8 * n) = pack_bf16(o[n][2], o[n][3]);
        }
      }
    } else if (active) {
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

template <int DF, bool RES, bool DROP, bool HB, typename TI, typename TO>
cudaError_t launch_packed_block(const TI* q, const TI* k, const TI* v, const float* bias,
                                long long bias_bs, int bias_qs, TO* out, int batch, int heads,
                                int sq, int sk, int hd, float scale, DropArgs drop, int in_rs,
                                int out_rs, HeadBias hb, cudaStream_t stream) {
  // the attribute is a ceiling, set once per instance; each launch asks for its own size
  static const cudaError_t attribute =
      cudaFuncSetAttribute(packed_block_kernel<DF, RES, DROP, HB, TI, TO>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attribute != cudaSuccess) return attribute;
  const long long smem = packed_block_smem_bytes(sk, DF, RES);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int rounds = ((sq + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  // resident: one block per (sample, head) walks every round, unless too few
  // (sample, head) pairs would fill two blocks on each of the 132 SMs
  const int pairs = batch * heads;
  const int split = RES ? (2 * 132 + pairs - 1) / pairs : rounds;
  const dim3 grid(rounds < split ? rounds : split, heads, batch);
  packed_block_kernel<DF, RES, DROP, HB, TI, TO><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, bias, bias_bs, bias_qs, out, sq, sk, hd, scale, drop, in_rs, out_rs, hb);
  return cudaGetLastError();
}

// in_rs, out_rs: the bf16 instance's row strides (elements; ignored for f32);
// hb: HB's head bias
template <bool DROP, bool HB = false, typename TI = float, typename TO = float>
cudaError_t launch_packed(const TI* q, const TI* k, const TI* v, const float* bias,
                          long long bias_bs, int bias_qs, TO* out, int batch, int sq, int sk,
                          int hd, int heads, float scale, int resident, DropArgs drop,
                          cudaStream_t stream, int in_rs = 0, int out_rs = 0,
                          HeadBias hb = HeadBias{}) {
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
    return resident ? launch_packed_block<df, true, DROP, HB>(q, k, v, bias, bias_bs, bias_qs, \
                                                               out, batch, heads, sq, sk, hd,  \
                                                               scale, drop, in_rs, out_rs, hb, \
                                                               stream)                         \
                    : launch_packed_block<df, false, DROP, HB>(q, k, v, bias, bias_bs,         \
                                                                bias_qs, out, batch, heads, sq, \
                                                                sk, hd, scale, drop, in_rs,    \
                                                                out_rs, hb, stream);
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

}  // namespace

cudaError_t packed_attention_qkv(const bf16* qkv, const float* key_bias, bf16* out, int batch,
                                 int seq, int hd, int heads, float scale, int resident,
                                 cudaStream_t stream) {
  if (hd % 8) return cudaErrorInvalidValue;  // 16-byte aligned k and v column blocks
  return launch_packed<false, false>(qkv, qkv + hd, qkv + 2 * hd, key_bias, seq, 0, out, batch,
                                     seq, seq, hd, heads, scale, resident, DropArgs{}, stream,
                                     3 * hd, hd);
}

}  // namespace ovq

extern "C" int ovq_packed_attention_forward(const float* q, const float* k, const float* v,
                                            const float* bias, long long bias_bs, int bias_qs,
                                            float* out, int batch, int sq, int sk, int hd,
                                            int heads, float scale, int resident,
                                            cudaStream_t stream) {
  return ovq::launch_packed<false>(q, k, v, bias, bias_bs, bias_qs, out, batch, sq, sk, hd, heads,
                                   scale, resident, ovq::DropArgs{}, stream);
}

// The two-bias entry (block B's HB instance): the packed entry's operands and
// the (hb, heads, sq, sk) f32 head bias, hb in {1, batch} (head_bias_bs 0 or
// heads * sq * sk); resident as the packed entry's flag
extern "C" int ovq_packed_2bias_attention_forward(const float* q, const float* k,
                                                  const float* v, const float* bias,
                                                  long long bias_bs, int bias_qs,
                                                  const float* head_bias, long long head_bias_bs,
                                                  float* out, int batch, int sq, int sk, int hd,
                                                  int heads, float scale, int resident,
                                                  cudaStream_t stream) {
  if (head_bias == nullptr) return cudaErrorInvalidValue;
  return ovq::launch_packed<false, true>(
      q, k, v, bias, bias_bs, bias_qs, out, batch, sq, sk, hd, heads, scale, resident,
      ovq::DropArgs{}, stream, 0, 0,
      ovq::HeadBias{head_bias, head_bias_bs, (long long)sq * sk, sk});
}

// The dropout forward (block B's DROP instance): out, the rows' (max, 1 /
// denominator) as (b, heads, sq) float2 `stats` and the keep bits as (b, heads,
// sq, ceil(sk / 32)) int32 words; `seed` points at one int64 on the device, so
// drawing it never waits for the host.
extern "C" int ovq_packed_dropout_forward(const float* q, const float* k, const float* v,
                                          const float* bias, long long bias_bs, int bias_qs,
                                          const long long* seed, int threshold, float keep_scale,
                                          float* stats, int* bits, float* out, int batch, int sq,
                                          int sk, int hd, int heads, float scale, int resident,
                                          cudaStream_t stream) {
  if (seed == nullptr || stats == nullptr || bits == nullptr || threshold < 0)
    return cudaErrorInvalidValue;
  const ovq::DropArgs drop{seed, (unsigned)threshold, keep_scale,
                           reinterpret_cast<float2*>(stats), reinterpret_cast<unsigned*>(bits)};
  return ovq::launch_packed<true>(q, k, v, bias, bias_bs, bias_qs, out, batch, sq, sk, hd, heads,
                                  scale, resident, drop, stream);
}
