// Kernel D: one M4C decode token through a BERT self-attention sublayer over
// [read-only context K/V | decoded slots]:
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv      (one row per sample)
//   slot_k[:, t], slot_v[:, t] = k, v              (t = min(step, T - 1))
//   y = LayerNorm(x + softmax(scale * q . [ctx_k | slot_k[:, :t+1]] + bias) [ctx_v | ...] Wo + bo)
//
// Replaces the Pallas kernel `_bert_self_kernel` / `fused_bert_self_step`
// (openvivqa_tpu/ops/decode_step.py).  As there, the context K/V is never written,
// only the (bs, T, hd) slot caches are, future slots are masked and padded context
// keys carry MASK_VALUE in ctx_bias; q and the softmax stay f32 over the stored
// (bf16) keys and values.  The slot caches are updated in place.
//
// On the H100 a decode step is bound by reading: the q|k|v and out projection
// weights (4 * 768^2 bf16 = 4.7 MB) and the context K/V (64 x ~215 x 768 x 2 x 2 =
// 42 MB per layer at batch 64), against ~0.3 GFLOP (counted from the shapes).
// The design reads each context key and value once per (sample, head): a block
// per (head, sample) walks the
// keys in chunks of 64 with an online softmax (running max and denominator), a loop
// taking the place of the TPU kernel's sequential chunk grid dimension, with no
// padding of the context to a chunk multiple.  Three launches: the q|k|v GEMM
// (f32 out), the attention step, and the out projection + residual + LayerNorm
// from common.cu.  Fusing the three (the projections are tiny at 64 rows) is for
// later work.
#include "common.cuh"

namespace ovq {

__global__ void __launch_bounds__(kStepThreads)
    bert_self_step_attn_kernel(const float* __restrict__ qkv, const bf16* __restrict__ ctx_k,
                               const bf16* __restrict__ ctx_v, const float* __restrict__ ctx_bias,
                               bf16* slot_k, bf16* slot_v, float* __restrict__ out, int ctx_len,
                               int n_slots, int t, int hd, int d, float scale) {
  __shared__ float qs[kStepMaxHeadDim];
  __shared__ float ps[kStepChunk];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t col = (size_t)h * d;

  const float* row = qkv + (size_t)b * 3 * hd + col;
  bf16* sk = slot_k + (size_t)b * n_slots * hd + col;
  bf16* sv = slot_v + (size_t)b * n_slots * hd + col;
  for (int c = threadIdx.x; c < d; c += kStepThreads) {
    qs[c] = row[c];
    sk[(size_t)t * hd + c] = __float2bfloat16(row[hd + c]);
    sv[(size_t)t * hd + c] = __float2bfloat16(row[2 * hd + c]);
  }
  __syncthreads();

  float m = -INFINITY, s = 0.0f;
  float acc[2] = {0.0f, 0.0f};
  // the decoded slots 0..t first (bias 0; later slots are masked, so skipped),
  // then the frozen context with its padding bias
  fold_keys(sk, sv, [](int) { return 0.0f; }, t + 1, hd, d, scale, qs, ps, m, s, acc);
  const float* cb = ctx_bias + (size_t)b * ctx_len;
  fold_keys(ctx_k + (size_t)b * ctx_len * hd + col, ctx_v + (size_t)b * ctx_len * hd + col,
            [cb](int j) { return cb[j]; }, ctx_len, hd, d, scale, qs, ps, m, s, acc);

  float* orow = out + (size_t)b * hd + col;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = threadIdx.x + u * kStepThreads;
    if (c < d) orow[c] = acc[u] / s;
  }
}

}  // namespace ovq

extern "C" int ovq_bert_self_step_forward(
    const float* x, const ovq::bf16* wqkv, const float* bqkv, const ovq::bf16* wo,
    const float* bo, const float* gamma, const float* beta, const ovq::bf16* ctx_k,
    const ovq::bf16* ctx_v, const float* ctx_bias, ovq::bf16* slot_k, ovq::bf16* slot_v,
    float* qkv, float* ctx, float* partial, float* y, int bs, int ctx_len, int n_slots, int t,
    int hd, int heads, int splits, int k_per_split, float scale, float eps, cudaStream_t stream) {
  const int d = hd / heads;
  if (d > ovq::kStepMaxHeadDim) return cudaErrorInvalidValue;
  cudaError_t err =
      ovq::launch_gemm_bias<float, float>(x, hd, wqkv, bqkv, qkv, 3 * hd, bs, 3 * hd, hd, stream);
  if (err != cudaSuccess) return err;
  ovq::bert_self_step_attn_kernel<<<dim3(heads, bs), ovq::kStepThreads, 0, stream>>>(
      qkv, ctx_k, ctx_v, ctx_bias, slot_k, slot_v, ctx, ctx_len, n_slots, t, hd, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ovq::launch_gemm_residual_ln<float>(ctx, hd, wo, bo, x, gamma, beta, y, partial, splits,
                                             k_per_split, bs, hd, hd, eps, stream);
}
