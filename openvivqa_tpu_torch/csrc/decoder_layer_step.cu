// Kernels A, B and the decoder-layer step: one decode token of a post-LN
// transformer decoder layer on (rows, hd) float32 rows (rows = samples x beams).
//
//   A  ovq_self_attention_step_forward: the stateful self-attention sublayer
//        q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
//        cache_k[:, t], cache_v[:, t], cache_bias[:, t] = k, v, step_bias   (in place)
//        y = LN(x + softmax(scale q . cache_k + cache_bias + future mask) cache_v Wo + bo)
//      with t = min(step, T - 1) clamped by the caller, slots past t masked with
//      MASK_VALUE inside the kernel, the ring (rows, T, hd) float32 or bf16 (a
//      store rounds, the attention reads what the ring holds) and the
//      LayerNorm's eps an argument;
//   B  ovq_cross_attention_step_forward: the cross-attention sublayer over the
//      cached encoder projections enc_k, enc_v (rows, Sk, hd; float32 or bf16)
//      with a (rows, Sk) float32 bias
//        y = LN(x + softmax(scale (x Wq + bq) . enc_k + enc_bias) enc_v Wo + bo);
//   ovq_decoder_layer_step_forward: A, then B on A's rows, then kernel C (the
//      FFN sublayer, ffn.cu) on B's rows, under one eps;
//   E  ovq_cross_attention_streamed_forward: the Iterative M4C family's
//      cross-attention sublayer over the frozen encoder projections (rows, S, hd),
//      the same function as B, called with the BertLayer eps of 1e-12.
//
// They replace the Pallas kernels `_self_attn_kernel` / `fused_self_attention_step`,
// `_cross_attn_kernel` / `fused_cross_attention_step`, `_layer_kernel` /
// `fused_decoder_layer_step` and `_streamed_cross_kernel` /
// `fused_cross_attention_streamed` (openvivqa_tpu/ops/decode_step.py).  The TPU's
// kernel E differs from its B only in layout: it pads the encoder K/V to a chunk
// multiple and walks the chunks over a sequential grid dimension because a
// 210-key block does not fit VMEM beside the weights.  Here B's attention block
// already walks the keys in 64-key chunks under an online softmax with a count
// for the ragged end, so E runs B's device code behind its own entry (and the
// wrapper's own launch counter); nothing is padded.  Weight matrices
// are bf16 (K, N) row-major, activations are rounded to bf16 at each product,
// sums, softmax (over f32 queries and the stored keys) and LayerNorm are f32; the
// FFN's GELU is the exact erff one of kernel C.  Nothing assumes that a row keeps
// its history between calls: beam search reorders the ring between steps and
// the attention reads whatever the ring holds.
//
// On the H100 a step at beam-search sizes (63 rows, hd 512, d_ff 2048, T of 5 to
// ~40, Sk ~110) is bound by reading: 7.3 MB of bf16 weights and 2 x rows x Sk x
// hd x 2 bytes of encoder K/V per layer, against ~0.5 GFLOP (counted from the
// shapes).  The TPU layer kernel runs its nine products, two attentions and three
// LayerNorms in sequence inside one grid cell; here nothing carries between
// blocks and each LayerNorm needs whole rows, so each entry chains a short, fixed
// sequence of device kernels on the stream:
//   A: q|k|v GEMM (common.cu), the ring write + attention (one block per (head,
//      row), a loop over 64-key chunks with an online softmax), out projection +
//      residual + LayerNorm (split over K while 32-row blocks cannot fill the
//      card, then a one-block-per-row reduce): 4 device launches, 3 when K is
//      not split;
//   B: q GEMM, attention over the encoder K/V, out projection + residual +
//      LayerNorm: 4 (3) device launches;
//   layer: A + B + C's (the bf16 cast of B's rows and gemm_sm90.cu's two products,
//      with a split-K reduce pass each at these row counts) = 13 device launches a
//      call, 11 when A's and B's K is not split.
// One cooperative or cluster-wide launch, and a CUDA graph over the step, are
// left for later work.
#include "common.cuh"

extern "C" int ovq_ffn_forward(const float* x, const ovq::bf16* w1, const float* b1,
                               const ovq::bf16* w2, const float* b2, const float* gamma,
                               const float* beta, ovq::bf16* xb, ovq::bf16* hidden,
                               float* partial, float* y, int rows, int hd, int d_ff, int bm1,
                               int bn1, int splits1, int k_slice1, int cluster1, int bm2, int bn2,
                               int splits2, int k_slice2, int cluster2, float eps,
                               cudaStream_t stream);

namespace ovq {

// the ring write of this (head, row)'s k and v at slot t, then the attention
// over all T slots: slot t carries the step's padding bias, slots before it what
// earlier steps wrote, slots after it MASK_VALUE on top
template <typename TK>
__global__ void __launch_bounds__(kStepThreads)
    self_step_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ step_bias,
                          TK* cache_k, TK* cache_v, float* cache_bias, float* __restrict__ out,
                          int max_len, int t, int hd, int d, float scale) {
  __shared__ float qs[kStepMaxHeadDim];
  __shared__ float ps[kStepChunk];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t col = (size_t)h * d;

  const float* row = qkv + (size_t)b * 3 * hd + col;
  TK* ck = cache_k + (size_t)b * max_len * hd + col;
  TK* cv = cache_v + (size_t)b * max_len * hd + col;
  for (int c = threadIdx.x; c < d; c += kStepThreads) {
    qs[c] = row[c];
    store_value(ck + (size_t)t * hd + c, row[hd + c]);
    store_value(cv + (size_t)t * hd + c, row[2 * hd + c]);
  }
  // every head's block reads the row's cached biases at slots other than t;
  // the first head's block alone writes slot t, which the others take from
  // step_bias
  const float sb = step_bias[b];
  float* cb = cache_bias + (size_t)b * max_len;
  if (h == 0 && threadIdx.x == 0) cb[t] = sb;
  __syncthreads();

  float m = -INFINITY, s = 0.0f;
  float acc[2] = {0.0f, 0.0f};
  fold_keys(
      ck, cv,
      [cb, sb, t](int j) { return (j == t ? sb : cb[j]) + (j > t ? kMaskValue : 0.0f); },
      max_len, hd, d, scale, qs, ps, m, s, acc);

  float* orow = out + (size_t)b * hd + col;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = threadIdx.x + u * kStepThreads;
    if (c < d) orow[c] = acc[u] / s;
  }
}

template <typename TK>
__global__ void __launch_bounds__(kStepThreads)
    cross_step_attn_kernel(const float* __restrict__ q, const TK* __restrict__ enc_k,
                           const TK* __restrict__ enc_v, const float* __restrict__ enc_bias,
                           float* __restrict__ out, int sk, int hd, int d, float scale) {
  __shared__ float qs[kStepMaxHeadDim];
  __shared__ float ps[kStepChunk];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t col = (size_t)h * d;

  for (int c = threadIdx.x; c < d; c += kStepThreads) qs[c] = q[(size_t)b * hd + col + c];
  __syncthreads();

  float m = -INFINITY, s = 0.0f;
  float acc[2] = {0.0f, 0.0f};
  const float* eb = enc_bias + (size_t)b * sk;
  fold_keys(enc_k + (size_t)b * sk * hd + col, enc_v + (size_t)b * sk * hd + col,
            [eb](int j) { return eb[j]; }, sk, hd, d, scale, qs, ps, m, s, acc);

  float* orow = out + (size_t)b * hd + col;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = threadIdx.x + u * kStepThreads;
    if (c < d) orow[c] = acc[u] / s;
  }
}

// the workspaces of one sublayer: qkv (rows, 3 hd) or q (rows, hd), the attention's
// context (rows, hd), and the K-split partial rows of the out projection
struct StepWorkspace {
  float* qkv;
  float* ctx;
  float* partial;
  int splits;
  int k_per_split;
};

struct AttentionWeights {
  const bf16* w_in;  // wq|wk|wv (hd, 3 hd) for A, wq (hd, hd) for B
  const float* b_in;
  const bf16* wo;
  const float* bo;
  const float* gamma;
  const float* beta;
};

static bool step_shape_ok(int rows, int keys, int hd, int heads) {
  return rows > 0 && keys > 0 && heads > 0 && hd % heads == 0 && hd / heads <= kStepMaxHeadDim;
}

template <typename TK>
static cudaError_t self_step(const float* x, const AttentionWeights& w, const float* step_bias,
                             void* cache_k, void* cache_v, float* cache_bias,
                             const StepWorkspace& ws, float* y, int rows, int max_len, int t,
                             int hd, int heads, float scale, float eps, cudaStream_t stream) {
  if (!step_shape_ok(rows, max_len, hd, heads) || t < 0 || t >= max_len)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_gemm_bias<float, float>(x, hd, w.w_in, w.b_in, ws.qkv, 3 * hd, rows,
                                                   3 * hd, hd, stream);
  if (err != cudaSuccess) return err;
  self_step_attn_kernel<TK><<<dim3(heads, rows), kStepThreads, 0, stream>>>(
      ws.qkv, step_bias, static_cast<TK*>(cache_k), static_cast<TK*>(cache_v), cache_bias,
      ws.ctx, max_len, t, hd, hd / heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm_residual_ln<float>(ws.ctx, hd, w.wo, w.bo, x, w.gamma, w.beta, y,
                                        ws.partial, ws.splits, ws.k_per_split, rows, hd, hd, eps,
                                        stream);
}

template <typename TK>
static cudaError_t cross_step(const float* x, const AttentionWeights& w, const void* enc_k,
                              const void* enc_v, const float* enc_bias, const StepWorkspace& ws,
                              float* y, int rows, int sk, int hd, int heads, float scale,
                              float eps, cudaStream_t stream) {
  if (!step_shape_ok(rows, sk, hd, heads)) return cudaErrorInvalidValue;
  cudaError_t err = launch_gemm_bias<float, float>(x, hd, w.w_in, w.b_in, ws.qkv, hd, rows, hd,
                                                   hd, stream);
  if (err != cudaSuccess) return err;
  cross_step_attn_kernel<TK><<<dim3(heads, rows), kStepThreads, 0, stream>>>(
      ws.qkv, static_cast<const TK*>(enc_k), static_cast<const TK*>(enc_v), enc_bias, ws.ctx, sk,
      hd, hd / heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm_residual_ln<float>(ws.ctx, hd, w.wo, w.bo, x, w.gamma, w.beta, y,
                                        ws.partial, ws.splits, ws.k_per_split, rows, hd, hd, eps,
                                        stream);
}

}  // namespace ovq

// cache_bf16 / enc_bf16: 1 when the ring / the encoder K/V hold bf16, 0 for float32
extern "C" int ovq_self_attention_step_forward(
    const float* x, const ovq::bf16* wqkv, const float* bqkv, const ovq::bf16* wo,
    const float* bo, const float* gamma, const float* beta, const float* step_bias,
    void* cache_k, void* cache_v, float* cache_bias, float* qkv, float* ctx, float* partial,
    float* y, int rows, int max_len, int t, int hd, int heads, int cache_bf16, int splits,
    int k_per_split, float scale, float eps, cudaStream_t stream) {
  const ovq::AttentionWeights w{wqkv, bqkv, wo, bo, gamma, beta};
  const ovq::StepWorkspace ws{qkv, ctx, partial, splits, k_per_split};
  return cache_bf16
             ? ovq::self_step<ovq::bf16>(x, w, step_bias, cache_k, cache_v, cache_bias, ws, y,
                                         rows, max_len, t, hd, heads, scale, eps, stream)
             : ovq::self_step<float>(x, w, step_bias, cache_k, cache_v, cache_bias, ws, y, rows,
                                     max_len, t, hd, heads, scale, eps, stream);
}

extern "C" int ovq_cross_attention_step_forward(
    const float* x, const ovq::bf16* wq, const float* bq, const ovq::bf16* wo, const float* bo,
    const float* gamma, const float* beta, const void* enc_k, const void* enc_v,
    const float* enc_bias, float* q, float* ctx, float* partial, float* y, int rows, int sk,
    int hd, int heads, int enc_bf16, int splits, int k_per_split, float scale, float eps,
    cudaStream_t stream) {
  const ovq::AttentionWeights w{wq, bq, wo, bo, gamma, beta};
  const ovq::StepWorkspace ws{q, ctx, partial, splits, k_per_split};
  return enc_bf16 ? ovq::cross_step<ovq::bf16>(x, w, enc_k, enc_v, enc_bias, ws, y, rows, sk, hd,
                                               heads, scale, eps, stream)
                  : ovq::cross_step<float>(x, w, enc_k, enc_v, enc_bias, ws, y, rows, sk, hd,
                                           heads, scale, eps, stream);
}

// kernel E: the arguments of B's entry, the eps the caller's (1e-12 for BertLayer)
extern "C" int ovq_cross_attention_streamed_forward(
    const float* x, const ovq::bf16* wq, const float* bq, const ovq::bf16* wo, const float* bo,
    const float* gamma, const float* beta, const void* enc_k, const void* enc_v,
    const float* enc_bias, float* q, float* ctx, float* partial, float* y, int rows, int sk,
    int hd, int heads, int enc_bf16, int splits, int k_per_split, float scale, float eps,
    cudaStream_t stream) {
  return ovq_cross_attention_step_forward(x, wq, bq, wo, bo, gamma, beta, enc_k, enc_v, enc_bias,
                                          q, ctx, partial, y, rows, sk, hd, heads, enc_bf16,
                                          splits, k_per_split, scale, eps, stream);
}

// y1 and y2 (rows, hd) carry the rows between the sublayers; xb (rows, hd) and
// hidden (rows, d_ff) bf16 are kernel C's, and (bm1 ... cluster2) its two plans;
// partial holds the most floats any of A's, B's and C's products asks for
extern "C" int ovq_decoder_layer_step_forward(
    const float* x, const ovq::bf16* s_wqkv, const float* s_bqkv, const ovq::bf16* s_wo,
    const float* s_bo, const float* s_gamma, const float* s_beta, const ovq::bf16* c_wq,
    const float* c_bq, const ovq::bf16* c_wo, const float* c_bo, const float* c_gamma,
    const float* c_beta, const ovq::bf16* f_w1, const float* f_b1, const ovq::bf16* f_w2,
    const float* f_b2, const float* f_gamma, const float* f_beta, const float* step_bias,
    void* cache_k, void* cache_v, float* cache_bias, const void* enc_k, const void* enc_v,
    const float* enc_bias, float* qkv, float* ctx, float* partial, float* y1, float* y2,
    ovq::bf16* xb, ovq::bf16* hidden, float* y, int rows, int max_len, int t, int sk, int hd,
    int heads, int d_ff, int cache_bf16, int enc_bf16, int splits, int k_per_split, int bm1,
    int bn1, int splits1, int k_slice1, int cluster1, int bm2, int bn2, int splits2, int k_slice2,
    int cluster2, float scale, float eps, cudaStream_t stream) {
  int err = ovq_self_attention_step_forward(
      x, s_wqkv, s_bqkv, s_wo, s_bo, s_gamma, s_beta, step_bias, cache_k, cache_v, cache_bias,
      qkv, ctx, partial, y1, rows, max_len, t, hd, heads, cache_bf16, splits, k_per_split, scale,
      eps, stream);
  if (err != cudaSuccess) return err;
  err = ovq_cross_attention_step_forward(y1, c_wq, c_bq, c_wo, c_bo, c_gamma, c_beta, enc_k,
                                         enc_v, enc_bias, qkv, ctx, partial, y2, rows, sk, hd,
                                         heads, enc_bf16, splits, k_per_split, scale, eps, stream);
  if (err != cudaSuccess) return err;
  return ovq_ffn_forward(y2, f_w1, f_b1, f_w2, f_b2, f_gamma, f_beta, xb, hidden, partial, y,
                         rows, hd, d_ff, bm1, bn1, splits1, k_slice1, cluster1, bm2, bn2, splits2,
                         k_slice2, cluster2, eps, stream);
}
