// Kernels A, B, D, E and the decoder-layer step: one decode token of a post-LN
// transformer decoder layer on (rows, hd) float32 rows (rows = samples x beams), all
// five entries in ONE persistent device launch of one kernel, each with its own
// sublayers as the kernel's phases.
//
//   A  ovq_self_attention_step_forward: the stateful self-attention sublayer
//        q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
//        cache_k[:, t], cache_v[:, t], cache_bias[:, t] = k, v, step_bias   (in place)
//        y = LN(x + softmax(scale q . cache_k + cache_bias + future mask) cache_v Wo + bo)
//      with t = min(step, T - 1) clamped by the caller, slots past t masked with
//      MASK_VALUE inside the kernel, the ring (rows, T, hd) float32 or bf16 (a
//      store rounds, the attention reads what the ring holds);
//   B  ovq_cross_attention_step_forward: the cross-attention sublayer over the
//      cached encoder projections enc_k, enc_v (rows, Sk, hd; float32 or bf16)
//      with a (rows, Sk) float32 bias
//        y = LN(x + softmax(scale (x Wq + bq) . enc_k + enc_bias) enc_v Wo + bo);
//   D  ovq_bert_self_step_forward: one M4C decode token through a BERT
//      self-attention sublayer over [frozen context | decoded slots]
//        q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
//        slot_k[:, t], slot_v[:, t] = k, v                              (in place)
//        y = LN(x + softmax(scale q . [ctx_k | slot_k] + [ctx_bias | 0, future mask])
//                 [ctx_v | slot_v] Wo + bo)
//      A's sublayer with the (rows, C) bf16 context K/V and its (rows, C) f32 bias
//      as a first key segment and the bf16 (rows, T) slot caches as the second, no
//      cache bias (slots carry bias 0), eps from the caller (1e-12 for BERT);
//   E  ovq_cross_attention_streamed_forward: B's function under the Iterative M4C
//      family's own entry (eps 1e-12 from the caller);
//   ovq_decoder_layer_step_forward: A, then B on A's rows, then kernel C's FFN
//      sublayer on B's rows, under one eps.
//
// They replace the Pallas kernels `_self_attn_call` (openvivqa_tpu/ops/
// decode_step.py:230), `_layer_call` (:418, the whole layer in one TPU grid cell),
// `_cross_attn_call` (:559), `_bert_self_call` (:892) and `_streamed_cross_call`
// (:1146).  Weight matrices
// are bf16 (K, N) row-major; every product rounds its activation to bf16 and sums
// in f32; the attentions take f32 queries against the keys and values as stored
// and an f32 softmax; LayerNorm is f32; the FFN's GELU is the exact erff one.
// Nothing assumes that a row keeps its history between calls: beam search
// reorders the ring between steps and the attention reads whatever it holds.
//
// What bounds it.  At IterativeMCAN's beam step (63 rows, hd 512, d_ff 2048, T 5,
// Sk 110) the layer reads 7.3 MB of bf16 weights, 14.2 MB of bf16 encoder K/V and
// the ring, ~23 MB against ~0.5 GFLOP: bytes, 0.0070 ms at 3.35 TB/s.  The chained
// route it replaces made 13 dependent launches a call, each filling and draining
// the card on a few hundred KB, with no weight streaming before its stage began.
// D at MMF_M4C's step (64 rows, hd 768, 8 heads of 96, C 210, T 5) reads 4.7 MB
// of bf16 weights and 41 MB of bf16 context K/V: bytes, 0.014 ms; the three
// launches it replaces (two wmma GEMMs and a block per (head, row) folding one
// key at a time) took ten times that.
//
// The design.  One cooperative launch of every CTA the card holds at once (two
// 256-thread CTAs per SM), each walking the work items of one phase after
// another; a grid-wide barrier (cooperative_groups' grid sync, whose state belongs
// to the launch) separates phases that read each other's outputs:
//   0. every CTA asks L2 to prefetch its share of each weight matrix and of the
//      encoder K/V (prefetch.global.L2::evict_last, 128-byte lines; ~23 MB at the
//      beam step against 50 MB of L2), so the layer's HBM stream overlaps the
//      phases before the ones that read it; x is rounded to bf16;
//   1. q|k|v (B: q) on gemm_sm90.cu's few-row scheme: 64 x 64 output tiles over
//      64-deep K slices (the split of ops/_cuda.py::gemm_plan), a TMA ring of four
//      stages fed by one producer thread, wgmma m64n64k16 in the consumer
//      warpgroup, raw f32 partial tiles; the ring's barriers and phase count
//      carry over from product to product;
//   2. the attention: one (row, head) item per warpgroup, two items per CTA at a
//      time, on block A's scheme (fused_attention_flat.cu): the item first sums
//      its q (and for A and D its k and v, written into slot t) from the
//      partials, then lane groups of 8 read key rows with 16-byte loads, several
//      rows in flight, and dot them with the f32 query held in registers; the
//      logits land in a shared row, the warpgroup takes their max and sum; a
//      second walk reads the value rows the same way; the context is written as
//      bf16, the out projection's operand.  D walks two key segments into one
//      logits row, the frozen context then slots 0..t: a slot past t carries
//      MASK_VALUE beside slot t's unmasked logit, so its weight is exactly 0 in
//      f32 and the walk stops at slot t;
//   3. the out projection's partial tiles (as 1);
//   4. bias + residual + LayerNorm, one row per CTA (reduce_ln_row), written in
//      f32 and, for the next sublayer's product, in bf16;
//   then B's sublayer (1-4) on those rows, then kernel C's: its two products
//   with the GELU pass between them and the LayerNorm pass after.  Where kernel
//   C's own route at this row count is the 64 x 64 split one (up to 512 rows at hd
//   512, 320 at hd 768), they take ops/decode_step.py::ffn_plans with the same
//   device functions and summation order as ffn.cu's split route, so the layer
//   step is bit-equal to A, B and C chained; past that they take A's and B's rule
//   (gemm_plan's split, else all of K in one slice), within rounding of C.
// A TMA (async proxy) load of rows written earlier in the launch by ordinary
// stores needs fence.proxy.async.global between the two, which every barrier
// executes.  A row count past what the grid holds at once loops over the items.
// A head dim that is not a multiple of 16 bytes' elements reads its rows element
// by element, one key row in flight (the 16-byte loads would be misaligned).
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace ovq {
namespace {

constexpr int kThreads = 256;  // two warpgroups: consumer and TMA producer, or two attention items
constexpr int kBK = 64;        // K per ring stage
constexpr int kTile = 64;      // rows and columns of one output tile
constexpr int kStages = 4;
constexpr int kStageBytes = 2 * kTile * kBK * 2;  // one A box and one W box, bf16
constexpr int kRingBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kGroup = 8;                            // lanes reading one key row
constexpr int kItemThreads = 128;                    // one attention item: a warpgroup
constexpr int kItemGroups = kItemThreads / kGroup;   // key rows per sweep of an item
constexpr int kItemWarps = kItemThreads / 32;

// the grid-wide barrier; ordinary stores of this phase (bf16 rows) may be read by
// TMA in the next
__device__ __forceinline__ void grid_sync() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cooperative_groups::this_grid().sync();
}

// one 128-byte line of L2 prefetch for each of this CTA's share of [p, p + bytes)
__device__ __forceinline__ void prefetch_share(const void* p, long long bytes) {
  if (p == nullptr || bytes <= 0) return;
  const long long lines = (bytes + 127) / 128;
  const long long per = (lines + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per;
  const long long last = first + per < lines ? first + per : lines;
  const size_t base = __cvta_generic_to_global(p);
  for (long long l = first + threadIdx.x; l < last; l += kThreads)
    asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(base + l * 128));
}

// -- the products: split-K partial tiles on a TMA ring ------------------------------
struct Ring {
  unsigned char* stages;  // kStages x (A box, W box), 1024-aligned
  uint64_t* full;
  uint64_t* empty;
  int it;  // k-blocks through the ring so far (the producer thread's and each consumer's)
};

struct Product {
  const CUtensorMap* a;  // bf16 (M, K) rows, boxes of 64 x 64
  const CUtensorMap* w;  // bf16 (K, N) weight, boxes of 64 x 64
  float* partial;        // (splits, M, N) f32
  int M, N, K, k_slice;
};

// partial[z] = A[:, slice z] @ W[slice z, :] in 64 x 64 tiles, the items (tile, z)
// walked over the grid; the consumer warpgroup's arithmetic is gemm_sm90.cu's
// gemm_body<1, 64, kEpiPartial>, k-block for k-block
__device__ void product_phase(const Product& p, Ring& ring) {
  const int tiles_n = (p.N + kTile - 1) / kTile, tiles_m = (p.M + kTile - 1) / kTile;
  const int splits = (p.K + p.k_slice - 1) / p.k_slice;
  const int items = tiles_n * tiles_m * splits;
  const int tid = threadIdx.x;
  if (tid >= 128) {
    if (tid != 128) return;
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int z = item % splits, tile = item / splits;
      const int m0 = (tile / tiles_n) * kTile, n0 = (tile % tiles_n) * kTile;
      const int k0 = z * p.k_slice;
      const int nk = (min(p.K, k0 + p.k_slice) - k0 + kBK - 1) / kBK;
      for (int i = 0; i < nk; ++i, ++ring.it) {
        const int s = ring.it % kStages;
        mbar_wait(&ring.empty[s], ((ring.it / kStages) & 1) ^ 1);
        mbar_expect_tx(&ring.full[s], kStageBytes);
        unsigned char* a = ring.stages + s * kStageBytes;
        const int kc = k0 + i * kBK;
        tma_load_2d(a, p.a, &ring.full[s], kc, m0);
        tma_load_2d(a + kTile * kBK * 2, p.w, &ring.full[s], n0, kc);
      }
    }
    return;
  }
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int lr0 = w * 16 + g;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int z = item % splits, tile = item / splits;
    const int m0 = (tile / tiles_n) * kTile, n0 = (tile % tiles_n) * kTile;
    const int k0 = z * p.k_slice;
    const int nk = (min(p.K, k0 + p.k_slice) - k0 + kBK - 1) / kBK;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int i = 0; i < nk; ++i, ++ring.it) {
      const int s = ring.it % kStages;
      mbar_wait(&ring.full[s], (ring.it / kStages) & 1);
      const unsigned char* a = ring.stages + s * kStageBytes;
      const unsigned char* b = a + kTile * kBK * 2;
      fence_operands(acc);  // zeroed (or summed) before the products start
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n64k16(acc, sw128_desc(a + 32 * kk, 16, 1024),
                        sw128_desc(b + 2048 * kk, kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (i > 0) mbar_arrive(&ring.empty[(ring.it - 1) % kStages]);
    }
    wgmma_wait<0>();
    mbar_arrive(&ring.empty[(ring.it - 1) % kStages]);
    fence_operands(acc);
    float* P = p.partial + (size_t)z * p.M * p.N;
    const int r0 = m0 + lr0, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (c >= p.N) continue;
      if (r0 < p.M)
        *reinterpret_cast<float2*>(P + (size_t)r0 * p.N + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r1 < p.M)
        *reinterpret_cast<float2*>(P + (size_t)r1 * p.N + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// -- the attention: one (row, head) item per warpgroup ------------------------------
// A lane holds DN / 8 values of a key or value row: f32 rows as DN / 32 float4 at
// columns (u * 8 + j) * 4, bf16 rows as DN / 64 uint4 (8 values) at (u * 8 + j) * 8,
// j the lane's place in its group of 8.
template <typename TK, int DN>
struct Rows {
  static constexpr bool kF32 = sizeof(TK) == 4;
  static constexpr int kRaw = kF32 ? DN / 32 : DN / 64;  // 16-byte loads a lane per row
  static constexpr int kVals = DN / 8;
  static constexpr int kPer = kF32 ? 4 : 8;  // values of one 16-byte load
  using Raw = typename std::conditional<kF32, float4, uint4>::type;
  using Elem = typename std::conditional<kF32, float, unsigned short>::type;
  __device__ static int col(int e, int j) {
    return kF32 ? ((e / 4) * kGroup + j) * 4 + e % 4 : ((e / 8) * kGroup + j) * 8 + e % 8;
  }
  // NC: the row is an input no phase writes (read through the non-coherent path);
  // ALIGNED: d is a multiple of kPer, so a head's columns start on 16 bytes
  template <bool NC, bool ALIGNED>
  __device__ static void load(Raw (&r)[kRaw], const TK* row, int j, int d, bool valid) {
#pragma unroll
    for (int u = 0; u < kRaw; ++u) {
      const int c = kF32 ? (u * kGroup + j) * 4 : (u * kGroup + j) * 8;
      if (!valid || c >= d) {
        r[u] = Raw{};
      } else if (ALIGNED) {
        const Raw* src = reinterpret_cast<const Raw*>(row + c);
        r[u] = NC ? __ldg(src) : *src;
      } else {  // the head's columns do not start on 16 bytes
        const Elem* src = reinterpret_cast<const Elem*>(row + c);
        alignas(16) Elem e[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) e[i] = c + i < d ? (NC ? __ldg(src + i) : src[i]) : Elem{};
        r[u] = *reinterpret_cast<const Raw*>(e);
      }
    }
  }
  __device__ static void unpack(float (&v)[kVals], const Raw (&r)[kRaw]) {
#pragma unroll
    for (int u = 0; u < kRaw; ++u) {
      if constexpr (kF32) {
        const float4 x = reinterpret_cast<const float4&>(r[u]);
        v[4 * u] = x.x;
        v[4 * u + 1] = x.y;
        v[4 * u + 2] = x.z;
        v[4 * u + 3] = x.w;
      } else {
        const uint4 x = reinterpret_cast<const uint4&>(r[u]);
        const unsigned words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&words[h]);
          v[8 * u + 2 * h] = __low2float(pair);
          v[8 * u + 2 * h + 1] = __high2float(pair);
        }
      }
    }
  }
};

// the warpgroup-wide max (MAX) or sum of one value per thread; `red` holds
// kItemWarps floats, `bar` is the warpgroup's named barrier
template <bool MAX>
__device__ __forceinline__ float group_reduce(float x, float* red, int bar) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  const int tid = threadIdx.x % kItemThreads;
  if (tid % 32 == 0) red[tid / 32] = x;
  named_barrier(bar, kItemThreads);
  x = red[0];
#pragma unroll
  for (int w = 1; w < kItemWarps; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  named_barrier(bar, kItemThreads);  // red is reused by the next call
  return x;
}

// scratch of one attention item: the logits of its keys, the four warps' partial
// outputs, the reduction's words
struct ItemScratch {
  float* q;     // [DN]
  float* w;     // [keys, rounded up to 4]
  float* part;  // [kItemWarps][DN]
  float* red;   // [kItemWarps]
};

// The key and value rows of one attention item, of stride hd (this head's
// columns first): keys [0, n0) from (k0, v0) and, with TWO, keys [n0, n) from
// (k1, v1) at rows j - n0 (kernel D: the frozen context, then the slots).
template <typename TK, bool TWO>
struct KeyRows {
  const TK* k0;
  const TK* v0;
  const TK* k1;
  const TK* v1;
  int n0;
  __device__ const TK* row(const TK* first, const TK* second, int j, int hd) const {
    if (TWO && j >= n0) return second + (size_t)(j - n0) * hd;
    return first + (size_t)j * hd;
  }
  __device__ const TK* key(int j, int hd) const { return row(k0, k1, j, hd); }
  __device__ const TK* value(int j, int hd) const { return row(v0, v1, j, hd); }
};

// softmax(logit_j) . values over n keys (`rows`), logit_j = scale * q . k_j +
// bias_of(j), q in s.q; the output's d columns, rounded to bf16, at out.  Every
// thread of the warpgroup calls it.  A head dim off the 16-byte grain (!ALIGNED)
// reads element by element, one key row at a time.
template <typename TK, int DN, bool NC, bool ALIGNED, bool TWO, typename BiasFn>
__device__ void attend_item(const KeyRows<TK, TWO> rows, BiasFn bias_of, int n, int hd, int d,
                            float scale, const ItemScratch& s, bf16* out, int bar) {
  using R = Rows<TK, DN>;
  // key rows in flight per group
  constexpr int kUnroll = !ALIGNED ? 1 : (DN <= 64 ? 4 : (DN <= 128 ? 2 : 1));
  const int tid = threadIdx.x % kItemThreads, warp = tid / 32, lane = tid % 32;
  const int group = tid / kGroup, j = tid % kGroup;
  float q[R::kVals];
#pragma unroll
  for (int e = 0; e < R::kVals; ++e) {
    const int c = R::col(e, j);
    q[e] = c < d ? s.q[c] : 0.0f;
  }
  // every key row read once: scale * q . k into w
  for (int base = 0; base < n; base += kItemGroups * kUnroll) {  // uniform: shuffles below
    typename R::Raw raw[kUnroll][R::kRaw];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + group + u * kItemGroups;
      R::template load<NC, ALIGNED>(raw[u], rows.key(key < n ? key : 0, hd), j, d, key < n);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[R::kVals];
      R::unpack(v, raw[u]);
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < R::kVals; ++e) dot = fmaf(q[e], v[e], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int key = base + group + u * kItemGroups;
      if (j == 0 && key < n) s.w[key] = dot * scale + bias_of(key);
    }
  }
  named_barrier(bar, kItemThreads);
  float m = -INFINITY;
  for (int c = tid; c < n; c += kItemThreads) m = fmaxf(m, s.w[c]);
  m = group_reduce<true>(m, s.red, bar);
  float sum = 0.0f;
  for (int c = tid; c < n; c += kItemThreads) {
    const float e = expf(s.w[c] - m);
    s.w[c] = e;
    sum += e;
  }
  sum = group_reduce<false>(sum, s.red, bar);  // its barriers publish w
  // every value row read once: sum_j e_j v_j per lane, then per warp
  float acc[R::kVals];
#pragma unroll
  for (int e = 0; e < R::kVals; ++e) acc[e] = 0.0f;
  for (int base = 0; base < n; base += kItemGroups * kUnroll) {
    typename R::Raw raw[kUnroll][R::kRaw];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + group + u * kItemGroups;
      R::template load<NC, ALIGNED>(raw[u], rows.value(key < n ? key : 0, hd), j, d, key < n);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + group + u * kItemGroups;
      const float p = key < n ? s.w[key] : 0.0f;
      float v[R::kVals];
      R::unpack(v, raw[u]);
#pragma unroll
      for (int e = 0; e < R::kVals; ++e) acc[e] = fmaf(p, v[e], acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < R::kVals; ++e) {
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
    const int c = R::col(e, j);
    if (lane < kGroup && c < d) s.part[warp * DN + c] = acc[e];
  }
  named_barrier(bar, kItemThreads);
  const float inv = 1.0f / sum;
  for (int c = tid; c < d; c += kItemThreads) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kItemWarps; ++w) total += s.part[w * DN + c];
    out[c] = __float2bfloat16(total * inv);
  }
  named_barrier(bar, kItemThreads);  // the scratch is free for the next item
}

// the sum of one projected column: bias + the `splits` (M, N) partial slices
__device__ __forceinline__ float projected(const float* partial, int splits, const float* bias,
                                           int M, int N, int row, int c) {
  float v = bias[c];
  for (int s = 0; s < splits; ++s) v += partial[((size_t)s * M + row) * N + c];
  return v;
}

// -- the kernel -------------------------------------------------------------------
struct Sublayer {
  const bf16* w_in;  // wq|wk|wv (hd, 3 hd) for A, wq (hd, hd) for B
  const float* b_in;
  const bf16* wo;
  const float* bo;
  const float* gamma;
  const float* beta;
  int k_slice_in, k_slice_out;  // the two products' K slices
};

struct StepParams {
  const float* x;  // (rows, hd) f32 input
  float* y;        // (rows, hd) f32 output
  // workspace: x rounded; per sublayer the attention's bf16 context, its f32 and
  // bf16 output rows (A's and B's feed the next sublayer); C's bf16 hidden; the
  // partial tiles of every product
  bf16* xb;
  bf16* ctx[2];
  float* rows[2];
  bf16* rows_b[2];
  bf16* hidden;
  float* partial;
  Sublayer self, cross;
  // A's ring and the step's padding bias
  const float* step_bias;
  void* cache_k;
  void* cache_v;
  float* cache_bias;
  // D: the frozen context's bf16 K/V (rows, frozen_len, hd) and its f32 bias;
  // the slot caches are cache_k, cache_v (bf16), with no cache bias
  const bf16* frozen_k;
  const bf16* frozen_v;
  const float* frozen_bias;
  int frozen_len, bert;  // bert: launch D's instance of the kernel
  // B's encoder K/V and bias
  const void* enc_k;
  const void* enc_v;
  const float* enc_bias;
  // C
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* f_gamma;
  const float* f_beta;
  int k_slice1, k_slice2;
  int rows_n, hd, heads, d, max_len, t, sk, d_ff, keys_max;
  int cache_bf16, enc_bf16;
  int run_self, run_cross, run_ffn;
  float scale, eps;
};

// the A operands and weights of the six products
struct StepMaps {
  CUtensorMap xb, s_w, s_ctx, s_wo, c_in, c_wq, c_ctx, c_wo, f_in, w1, hidden, w2;
};

template <int DN>
__device__ ItemScratch item_scratch(float* base, int keys_max, int wg) {
  const int per = DN + (keys_max + 3) / 4 * 4 + kItemWarps * DN + kItemWarps;
  float* b = base + wg * per;
  return ItemScratch{b, b + DN, b + DN + (keys_max + 3) / 4 * 4,
                     b + DN + (keys_max + 3) / 4 * 4 + kItemWarps * DN};
}

// attend_item at the instance for this call's head dim
template <typename TK, int DN, bool NC, bool TWO, typename BiasFn>
__device__ __forceinline__ void attend(const KeyRows<TK, TWO> rows, BiasFn bias_of, int n,
                                       int hd, int d, float scale, const ItemScratch& s, bf16* out,
                                       int bar) {
  if (d % Rows<TK, DN>::kPer == 0)
    attend_item<TK, DN, NC, true>(rows, bias_of, n, hd, d, scale, s, out, bar);
  else
    attend_item<TK, DN, NC, false>(rows, bias_of, n, hd, d, scale, s, out, bar);
}

// the projected q, k and v of item (row b, head column col), summed from the
// partials; k and v stored into slot t of the (rows, T, hd) caches ck, cv
template <typename TK>
__device__ __forceinline__ void project_qkv(const StepParams& p, const ItemScratch& s, TK* ck,
                                            TK* cv, int b, int col) {
  const int hd = p.hd, n3 = 3 * hd, t = p.t;
  const int splits = (hd + p.self.k_slice_in - 1) / p.self.k_slice_in;
  for (int c = threadIdx.x % kItemThreads; c < p.d; c += kItemThreads) {
    s.q[c] = projected(p.partial, splits, p.self.b_in, p.rows_n, n3, b, col + c);
    store_value(ck + (size_t)t * hd + c,
                projected(p.partial, splits, p.self.b_in, p.rows_n, n3, b, hd + col + c));
    store_value(cv + (size_t)t * hd + c,
                projected(p.partial, splits, p.self.b_in, p.rows_n, n3, b, 2 * hd + col + c));
  }
}

// A's attention phase: per (row, head) item the projected q, k, v of the head
// (summed from the partials), k and v into ring slot t, the step's bias into
// cache_bias[row, t] (by head 0), then attention over the T slots
template <typename TK, int DN>
__device__ void self_attention_phase(const StepParams& p, float* scratch_base) {
  const int wg = threadIdx.x / kItemThreads, bar = 1 + wg;
  const ItemScratch s = item_scratch<DN>(scratch_base, p.keys_max, wg);
  const int tid = threadIdx.x % kItemThreads;
  const int hd = p.hd, d = p.d, t = p.t;
  TK* ck_all = static_cast<TK*>(p.cache_k);
  TK* cv_all = static_cast<TK*>(p.cache_v);
  for (int item = blockIdx.x * 2 + wg; item < p.rows_n * p.heads; item += gridDim.x * 2) {
    const int b = item / p.heads, h = item % p.heads;
    const int col = h * d;
    TK* ck = ck_all + (size_t)b * p.max_len * hd + col;
    TK* cv = cv_all + (size_t)b * p.max_len * hd + col;
    project_qkv(p, s, ck, cv, b, col);
    const float sb = p.step_bias[b];
    float* cb = p.cache_bias + (size_t)b * p.max_len;
    if (h == 0 && tid == 0) cb[t] = sb;
    named_barrier(bar, kItemThreads);  // q and slot t written
    // every head's item reads the row's cached biases at slots other than t;
    // head 0's item alone writes slot t, which the others take from step_bias
    attend<TK, DN, false>(
        KeyRows<TK, false>{ck, cv, nullptr, nullptr, 0},
        [cb, sb, t](int j) { return (j == t ? sb : cb[j]) + (j > t ? kMaskValue : 0.0f); },
        p.max_len, hd, d, p.scale, s, p.ctx[0] + (size_t)b * hd + col, bar);
  }
}

// D's attention phase: per (row, head) item the projected q, k, v (k and v into
// slot t of the bf16 slot caches), then one softmax over the frozen context's C
// keys under its bias and slots 0..t (bias 0).  The slots are read through the
// coherent path: slot t is written in this phase.
template <int DN>
__device__ void bert_self_attention_phase(const StepParams& p, float* scratch_base) {
  const int wg = threadIdx.x / kItemThreads, bar = 1 + wg;
  const ItemScratch s = item_scratch<DN>(scratch_base, p.keys_max, wg);
  const int hd = p.hd, d = p.d, c_len = p.frozen_len;
  bf16* sk_all = static_cast<bf16*>(p.cache_k);
  bf16* sv_all = static_cast<bf16*>(p.cache_v);
  for (int item = blockIdx.x * 2 + wg; item < p.rows_n * p.heads; item += gridDim.x * 2) {
    const int b = item / p.heads, h = item % p.heads;
    const int col = h * d;
    bf16* sk = sk_all + (size_t)b * p.max_len * hd + col;
    bf16* sv = sv_all + (size_t)b * p.max_len * hd + col;
    project_qkv(p, s, sk, sv, b, col);
    named_barrier(bar, kItemThreads);  // q and slot t written
    const size_t frozen = (size_t)b * c_len * hd + col;
    const float* fb = p.frozen_bias + (size_t)b * c_len;
    attend<bf16, DN, false>(
        KeyRows<bf16, true>{p.frozen_k + frozen, p.frozen_v + frozen, sk, sv, c_len},
        [fb, c_len](int j) { return j < c_len ? __ldg(fb + j) : 0.0f; }, c_len + p.t + 1, hd, d,
        p.scale, s, p.ctx[0] + (size_t)b * hd + col, bar);
  }
}

// B's attention phase: per (row, head) item the projected q, then attention over
// the encoder K/V under its bias
template <typename TK, int DN>
__device__ void cross_attention_phase(const StepParams& p, float* scratch_base) {
  const int wg = threadIdx.x / kItemThreads, bar = 1 + wg;
  const ItemScratch s = item_scratch<DN>(scratch_base, p.keys_max, wg);
  const int tid = threadIdx.x % kItemThreads;
  const int hd = p.hd, d = p.d;
  const int splits = (hd + p.cross.k_slice_in - 1) / p.cross.k_slice_in;
  const TK* ek = static_cast<const TK*>(p.enc_k);
  const TK* ev = static_cast<const TK*>(p.enc_v);
  for (int item = blockIdx.x * 2 + wg; item < p.rows_n * p.heads; item += gridDim.x * 2) {
    const int b = item / p.heads, h = item % p.heads;
    const int col = h * d;
    for (int c = tid; c < d; c += kItemThreads)
      s.q[c] = projected(p.partial, splits, p.cross.b_in, p.rows_n, hd, b, col + c);
    named_barrier(bar, kItemThreads);
    const float* eb = p.enc_bias + (size_t)b * p.sk;
    attend<TK, DN, true>(
        KeyRows<TK, false>{ek + (size_t)b * p.sk * hd + col, ev + (size_t)b * p.sk * hd + col,
                           nullptr, nullptr, 0},
        [eb](int j) { return __ldg(eb + j); }, p.sk, hd, d, p.scale, s,
        p.ctx[1] + (size_t)b * hd + col, bar);
  }
}

// bias + residual + LayerNorm of the out projection's partials, one row per CTA
__device__ void layer_norm_phase(const float* partial, int splits, const float* bias,
                                 const float* R, const float* gamma, const float* beta, float* Y,
                                 bf16* Yb, int M, int N, float eps, float* scratch) {
  for (int row = blockIdx.x; row < M; row += gridDim.x)
    reduce_ln_row(partial, splits, bias, R, gamma, beta, Y, Yb, M, N, eps, row, scratch);
}

// BERT: kernel D's instance (A's sublayer with D's attention, nothing else);
// the others' instances carry no code of D's, so that D's phase takes none of
// their registers
template <int DN, bool BERT>
__global__ void __launch_bounds__(kThreads, 2)
    decoder_step_kernel(const __grid_constant__ StepMaps maps, const __grid_constant__ StepParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  Ring ring{smem, reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes), nullptr, 0};
  ring.empty = ring.full + kStages;
  float* scratch = reinterpret_cast<float*>(ring.empty + kStages);  // the LayerNorm's words
  float* items = scratch + kRowThreads / 32;                        // the attention items'
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 128);
    }
    mbar_init_fence();
  }
  const int hd = p.hd, rows = p.rows_n;
  // 0. the weights and encoder K/V on their way to L2; x rounded to bf16
  if (p.run_self) {
    prefetch_share(p.self.w_in, 2LL * hd * 3 * hd);
    prefetch_share(p.self.wo, 2LL * hd * hd);
    if constexpr (BERT) {
      const long long frozen = 2LL * rows * p.frozen_len * hd, slots = 2LL * rows * p.max_len * hd;
      prefetch_share(p.frozen_k, frozen);
      prefetch_share(p.frozen_v, frozen);
      prefetch_share(p.cache_k, slots);
      prefetch_share(p.cache_v, slots);
    }
  }
  if (p.run_cross) {
    prefetch_share(p.cross.w_in, 2LL * hd * hd);
    prefetch_share(p.cross.wo, 2LL * hd * hd);
    const long long kv = (long long)rows * p.sk * hd * (p.enc_bf16 ? 2 : 4);
    prefetch_share(p.enc_k, kv);
    prefetch_share(p.enc_v, kv);
  }
  if (p.run_ffn) {
    prefetch_share(p.w1, 2LL * hd * p.d_ff);
    prefetch_share(p.w2, 2LL * hd * p.d_ff);
  }
  {
    const long long quads = (long long)rows * hd / 4;
    for (long long q = blockIdx.x * (long long)kThreads + threadIdx.x; q < quads;
         q += (long long)gridDim.x * kThreads)
      cast_quad(p.x, p.xb, q);
  }
  grid_sync();

  const float* x_in = p.x;  // the current sublayer's f32 input rows
  const CUtensorMap* in_map = &maps.xb;
  if (p.run_self) {
    const Sublayer& w = p.self;
    product_phase(Product{in_map, &maps.s_w, p.partial, rows, 3 * hd, hd, w.k_slice_in}, ring);
    grid_sync();
    if constexpr (BERT)
      bert_self_attention_phase<DN>(p, items);
    else if (p.cache_bf16)
      self_attention_phase<bf16, DN>(p, items);
    else
      self_attention_phase<float, DN>(p, items);
    grid_sync();
    product_phase(Product{&maps.s_ctx, &maps.s_wo, p.partial, rows, hd, hd, w.k_slice_out}, ring);
    grid_sync();
    layer_norm_phase(p.partial, (hd + w.k_slice_out - 1) / w.k_slice_out, w.bo, x_in, w.gamma,
                     w.beta, p.rows[0], p.rows_b[0], rows, hd, p.eps, scratch);
    x_in = p.rows[0];
    in_map = &maps.c_in;
    if (p.run_cross || p.run_ffn) grid_sync();
  }
  if (!BERT && p.run_cross) {
    const Sublayer& w = p.cross;
    product_phase(Product{in_map, &maps.c_wq, p.partial, rows, hd, hd, w.k_slice_in}, ring);
    grid_sync();
    if (p.enc_bf16)
      cross_attention_phase<bf16, DN>(p, items);
    else
      cross_attention_phase<float, DN>(p, items);
    grid_sync();
    product_phase(Product{&maps.c_ctx, &maps.c_wo, p.partial, rows, hd, hd, w.k_slice_out}, ring);
    grid_sync();
    layer_norm_phase(p.partial, (hd + w.k_slice_out - 1) / w.k_slice_out, w.bo, x_in, w.gamma,
                     w.beta, p.rows[1], p.rows_b[1], rows, hd, p.eps, scratch);
    x_in = p.rows[1];
    if (p.run_ffn) grid_sync();
  }
  if (!BERT && p.run_ffn) {
    // kernel C's split route (ffn.cu), phase for pass
    const int splits1 = (hd + p.k_slice1 - 1) / p.k_slice1;
    product_phase(Product{&maps.f_in, &maps.w1, p.partial, rows, p.d_ff, hd, p.k_slice1}, ring);
    grid_sync();
    const long long quads = (long long)rows * p.d_ff / 4, slice = (long long)rows * p.d_ff;
    for (long long q = blockIdx.x * (long long)kThreads + threadIdx.x; q < quads;
         q += (long long)gridDim.x * kThreads)
      reduce_bias_quad<true>(p.partial, splits1, p.b1, p.hidden, 4 * q, slice, p.d_ff);
    grid_sync();
    product_phase(Product{&maps.hidden, &maps.w2, p.partial, rows, hd, p.d_ff, p.k_slice2}, ring);
    grid_sync();
    layer_norm_phase(p.partial, (p.d_ff + p.k_slice2 - 1) / p.k_slice2, p.b2, x_in, p.f_gamma,
                     p.f_beta, p.y, nullptr, rows, hd, p.eps, scratch);
  }
}

// dynamic shared memory the kernel carves: the ring, the LayerNorm's words and
// two attention items' scratch (ops/decode_step.py::step_smem_bytes is the same sum)
long long step_smem_bytes(int dn, int keys_max) {
  const long long item = dn + (keys_max + 3) / 4 * 4 + kItemWarps * dn + kItemWarps;
  return kRingBytes + 4LL * (kRowThreads / 32) + 2 * 4 * item;
}

bool product_map(CUtensorMap* a, CUtensorMap* w, const bf16* rows_b, const bf16* weight, int M,
                 int N, int K) {
  return bf16_tensor_map(a, rows_b, M, K, kTile) && bf16_tensor_map(w, weight, K, N, kBK);
}

template <int DN, bool BERT>
cudaError_t launch_step_dn(const StepMaps& maps, const StepParams& p, int ctas, int smem,
                           cudaStream_t stream) {
  auto kernel = decoder_step_kernel<DN, BERT>;
  static int smem_set = 0;  // the ceiling last set for this instance
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeCooperative;
  attribute[0].val.cooperative = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, maps, p);
  // a refused launch (a grid the card cannot hold at once) is this call's error,
  // not the next launch's
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// the checks every entry shares, the maps of the products it runs, the launch
cudaError_t launch_step(StepParams& p, int ctas, int smem, cudaStream_t stream) {
  const int hd = p.hd, rows = p.rows_n;
  if (rows <= 0) return cudaSuccess;
  if (p.heads <= 0 || hd % p.heads || hd % 128 || hd > 1024 || ctas <= 0) return cudaErrorInvalidValue;
  p.d = hd / p.heads;
  if (p.d > 256) return cudaErrorInvalidValue;
  const int dn = p.d <= 64 ? 64 : (p.d <= 128 ? 128 : 256);
  if (smem < step_smem_bytes(dn, p.keys_max)) return cudaErrorInvalidValue;
  auto slices_ok = [](int a, int b) { return a > 0 && a % kBK == 0 && b > 0 && b % kBK == 0; };
  if ((p.run_self && !slices_ok(p.self.k_slice_in, p.self.k_slice_out)) ||
      (p.run_cross && !slices_ok(p.cross.k_slice_in, p.cross.k_slice_out)) ||
      (p.run_ffn && !slices_ok(p.k_slice1, p.k_slice2)))
    return cudaErrorInvalidValue;
  StepMaps maps = {};
  bool ok = bf16_tensor_map(&maps.xb, p.xb, rows, hd, kTile);
  if (p.run_self) {
    ok = ok && bf16_tensor_map(&maps.s_w, p.self.w_in, hd, 3 * hd, kBK) &&
         product_map(&maps.s_ctx, &maps.s_wo, p.ctx[0], p.self.wo, rows, hd, hd);
    if (p.max_len <= 0 || p.t < 0 || p.t >= p.max_len) return cudaErrorInvalidValue;
    if (p.bert && (!p.cache_bf16 || p.frozen_len < 0 || p.keys_max < p.frozen_len + p.max_len))
      return cudaErrorInvalidValue;
  }
  if (p.run_cross) {
    ok = ok && product_map(&maps.c_in, &maps.c_wq, p.run_self ? p.rows_b[0] : p.xb, p.cross.w_in,
                           rows, hd, hd) &&
         product_map(&maps.c_ctx, &maps.c_wo, p.ctx[1], p.cross.wo, rows, hd, hd);
    if (p.sk <= 0) return cudaErrorInvalidValue;
  }
  if (p.run_ffn) {
    if (p.d_ff <= 0 || p.d_ff % 8) return cudaErrorInvalidValue;
    ok = ok && product_map(&maps.f_in, &maps.w1, p.rows_b[1], p.w1, rows, p.d_ff, hd) &&
         product_map(&maps.hidden, &maps.w2, p.hidden, p.w2, rows, hd, p.d_ff);
  }
  if (!ok) return cudaErrorInvalidValue;
  switch (dn) {
    case 64:
      return p.bert ? launch_step_dn<64, true>(maps, p, ctas, smem, stream)
                    : launch_step_dn<64, false>(maps, p, ctas, smem, stream);
    case 128:
      return p.bert ? launch_step_dn<128, true>(maps, p, ctas, smem, stream)
                    : launch_step_dn<128, false>(maps, p, ctas, smem, stream);
    default:
      return p.bert ? launch_step_dn<256, true>(maps, p, ctas, smem, stream)
                    : launch_step_dn<256, false>(maps, p, ctas, smem, stream);
  }
}

}  // namespace
}  // namespace ovq

using ovq::bf16;

// cache_bf16 / enc_bf16: 1 when the ring / the encoder K/V hold bf16, 0 for float32.
// xb, ctx (bf16) and partial are the workspace; k_slice_* each product's K slice;
// ctas the persistent grid, smem its dynamic shared memory (ops/decode_step.py::step_plan)
extern "C" int ovq_self_attention_step_forward(
    const float* x, const bf16* wqkv, const float* bqkv, const bf16* wo, const float* bo,
    const float* gamma, const float* beta, const float* step_bias, void* cache_k, void* cache_v,
    float* cache_bias, bf16* xb, bf16* ctx, float* partial, float* y, int rows, int max_len, int t,
    int hd, int heads, int cache_bf16, int k_slice_qkv, int k_slice_o, int ctas, int smem,
    float scale, float eps, cudaStream_t stream) {
  ovq::StepParams p = {};
  p.x = x;
  p.xb = xb;
  p.ctx[0] = ctx;
  p.rows[0] = y;
  p.partial = partial;
  p.self = ovq::Sublayer{wqkv, bqkv, wo, bo, gamma, beta, k_slice_qkv, k_slice_o};
  p.step_bias = step_bias;
  p.cache_k = cache_k;
  p.cache_v = cache_v;
  p.cache_bias = cache_bias;
  p.rows_n = rows;
  p.hd = hd;
  p.heads = heads;
  p.max_len = max_len;
  p.t = t;
  p.keys_max = max_len;
  p.cache_bf16 = cache_bf16;
  p.run_self = 1;
  p.scale = scale;
  p.eps = eps;
  return ovq::launch_step(p, ctas, smem, stream);
}

// kernel D: A's arguments with the frozen context (ctx_k, ctx_v, ctx_bias; rows x
// ctx_len) in place of the cache bias and step bias, bf16 slot caches of n_slots
extern "C" int ovq_bert_self_step_forward(
    const float* x, const bf16* wqkv, const float* bqkv, const bf16* wo, const float* bo,
    const float* gamma, const float* beta, const bf16* ctx_k, const bf16* ctx_v,
    const float* ctx_bias, bf16* slot_k, bf16* slot_v, bf16* xb, bf16* ctx, float* partial,
    float* y, int rows, int ctx_len, int n_slots, int t, int hd, int heads, int k_slice_qkv,
    int k_slice_o, int ctas, int smem, float scale, float eps, cudaStream_t stream) {
  ovq::StepParams p = {};
  p.x = x;
  p.xb = xb;
  p.ctx[0] = ctx;
  p.rows[0] = y;
  p.partial = partial;
  p.self = ovq::Sublayer{wqkv, bqkv, wo, bo, gamma, beta, k_slice_qkv, k_slice_o};
  p.frozen_k = ctx_k;
  p.frozen_v = ctx_v;
  p.frozen_bias = ctx_bias;
  p.frozen_len = ctx_len;
  p.bert = 1;
  p.cache_k = slot_k;
  p.cache_v = slot_v;
  p.cache_bf16 = 1;
  p.rows_n = rows;
  p.hd = hd;
  p.heads = heads;
  p.max_len = n_slots;
  p.t = t;
  p.keys_max = ctx_len + n_slots;
  p.run_self = 1;
  p.scale = scale;
  p.eps = eps;
  return ovq::launch_step(p, ctas, smem, stream);
}

extern "C" int ovq_cross_attention_step_forward(
    const float* x, const bf16* wq, const float* bq, const bf16* wo, const float* bo,
    const float* gamma, const float* beta, const void* enc_k, const void* enc_v,
    const float* enc_bias, bf16* xb, bf16* ctx, float* partial, float* y, int rows, int sk, int hd,
    int heads, int enc_bf16, int k_slice_q, int k_slice_o, int ctas, int smem, float scale,
    float eps, cudaStream_t stream) {
  ovq::StepParams p = {};
  p.x = x;
  p.xb = xb;
  p.ctx[1] = ctx;
  p.rows[1] = y;
  p.partial = partial;
  p.cross = ovq::Sublayer{wq, bq, wo, bo, gamma, beta, k_slice_q, k_slice_o};
  p.enc_k = enc_k;
  p.enc_v = enc_v;
  p.enc_bias = enc_bias;
  p.rows_n = rows;
  p.hd = hd;
  p.heads = heads;
  p.sk = sk;
  p.keys_max = sk;
  p.enc_bf16 = enc_bf16;
  p.run_cross = 1;
  p.scale = scale;
  p.eps = eps;
  return ovq::launch_step(p, ctas, smem, stream);
}

// kernel E: B's arguments and launch, the eps the caller's (1e-12 for BertLayer)
extern "C" int ovq_cross_attention_streamed_forward(
    const float* x, const bf16* wq, const float* bq, const bf16* wo, const float* bo,
    const float* gamma, const float* beta, const void* enc_k, const void* enc_v,
    const float* enc_bias, bf16* xb, bf16* ctx, float* partial, float* y, int rows, int sk, int hd,
    int heads, int enc_bf16, int k_slice_q, int k_slice_o, int ctas, int smem, float scale,
    float eps, cudaStream_t stream) {
  return ovq_cross_attention_step_forward(x, wq, bq, wo, bo, gamma, beta, enc_k, enc_v, enc_bias,
                                          xb, ctx, partial, y, rows, sk, hd, heads, enc_bf16,
                                          k_slice_q, k_slice_o, ctas, smem, scale, eps, stream);
}

// the whole layer: A's rows (y1, y1b) into B, B's (y2, y2b) into C, whose hidden
// is bf16 (rows, d_ff); k_slice1 and k_slice2 are ffn_plans' K slices
extern "C" int ovq_decoder_layer_step_forward(
    const float* x, const bf16* s_wqkv, const float* s_bqkv, const bf16* s_wo, const float* s_bo,
    const float* s_gamma, const float* s_beta, const bf16* c_wq, const float* c_bq,
    const bf16* c_wo, const float* c_bo, const float* c_gamma, const float* c_beta,
    const bf16* f_w1, const float* f_b1, const bf16* f_w2, const float* f_b2,
    const float* f_gamma, const float* f_beta, const float* step_bias, void* cache_k,
    void* cache_v, float* cache_bias, const void* enc_k, const void* enc_v,
    const float* enc_bias, bf16* xb, bf16* ctx_s, float* y1, bf16* y1b, bf16* ctx_c, float* y2,
    bf16* y2b, bf16* hidden, float* partial, float* y, int rows, int max_len, int t, int sk,
    int hd, int heads, int d_ff, int cache_bf16, int enc_bf16, int k_slice_qkv, int k_slice_so,
    int k_slice_q, int k_slice_co, int k_slice1, int k_slice2, int ctas, int smem, float scale,
    float eps, cudaStream_t stream) {
  ovq::StepParams p = {};
  p.x = x;
  p.y = y;
  p.xb = xb;
  p.ctx[0] = ctx_s;
  p.ctx[1] = ctx_c;
  p.rows[0] = y1;
  p.rows[1] = y2;
  p.rows_b[0] = y1b;
  p.rows_b[1] = y2b;
  p.hidden = hidden;
  p.partial = partial;
  p.self = ovq::Sublayer{s_wqkv, s_bqkv, s_wo, s_bo, s_gamma, s_beta, k_slice_qkv, k_slice_so};
  p.cross = ovq::Sublayer{c_wq, c_bq, c_wo, c_bo, c_gamma, c_beta, k_slice_q, k_slice_co};
  p.step_bias = step_bias;
  p.cache_k = cache_k;
  p.cache_v = cache_v;
  p.cache_bias = cache_bias;
  p.enc_k = enc_k;
  p.enc_v = enc_v;
  p.enc_bias = enc_bias;
  p.w1 = f_w1;
  p.b1 = f_b1;
  p.w2 = f_w2;
  p.b2 = f_b2;
  p.f_gamma = f_gamma;
  p.f_beta = f_beta;
  p.k_slice1 = k_slice1;
  p.k_slice2 = k_slice2;
  p.rows_n = rows;
  p.hd = hd;
  p.heads = heads;
  p.max_len = max_len;
  p.t = t;
  p.sk = sk;
  p.d_ff = d_ff;
  p.keys_max = max_len > sk ? max_len : sk;
  p.cache_bf16 = cache_bf16;
  p.enc_bf16 = enc_bf16;
  p.run_self = p.run_cross = p.run_ffn = 1;
  p.scale = scale;
  p.eps = eps;
  return ovq::launch_step(p, ctas, smem, stream);
}
