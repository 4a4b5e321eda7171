// Packed attention with a second, per-head bias:
// softmax(scale * Q K^T + bias + head_bias) V on the raw (b, S, heads * d)
// projections, all heads of a sample in one launch, forward only.
//
// Replaces the Pallas kernel `_packed_2bias_kernel` / `fused_attention_packed_2bias`
// (openvivqa_tpu/ops/fused_attention.py).  As there, the dot operands are rounded
// to bf16, the row softmax is f32 and the softmax weights are rounded to bf16
// before the product with V.  `bias` is head-shared, (bb, bq, Sk) with bb in
// {1, b} and bq in {1, Sq}; `head_bias` is (hb, heads, Sq, Sk) with hb in {1, b}:
// T5's relative-position table is one (1, heads, L, L) block shared by the
// samples (read through a batch stride of 0, never broadcast), DeBERTa's
// disentangled terms are per sample.
//
// On the H100, at the mT5-small encoder of ViTmT5 (60 samples x 6 heads of 64 x
// L question tokens), the work is tiny: 4 b h L^2 d is 0.05 GFLOP at L = 24,
// against ~9 MB of projections and output (the shared table adds h L^2 floats),
// so the bytes bound it, and the launch's fixed cost weighs more than either;
// with 10-30 queries most rows of each 64-row q-tile idle.  It is the packed attention's block (common.cu, 64-key chunks
// through shared memory, wmma on the tensor cores, two passes so the weights are
// normalised before they are rounded) with the head bias read per logit from
// global memory, as the head-shared bias is; nothing of the TPU's q-block plan
// (which sized blocks to fit the per-head bias in VMEM) is needed.
#include "common.cuh"

extern "C" int ovq_packed_2bias_attention_forward(const float* q, const float* k,
                                                  const float* v, const float* bias,
                                                  long long bias_bs, int bias_qs,
                                                  const float* head_bias, long long head_bias_bs,
                                                  float* out, int batch, int sq, int sk, int hd,
                                                  int heads, float scale, cudaStream_t stream) {
  if (head_bias == nullptr) return cudaErrorInvalidValue;
  const int d = hd / heads;
  return ovq::launch_attention<float, float>(
      q, (long long)sq * hd, hd, k, v, (long long)sk * hd, hd, bias, bias_bs, bias_qs, out,
      (long long)sq * hd, hd, batch, heads, sq, sk, d, scale, stream,
      ovq::HeadBias{head_bias, head_bias_bs, (long long)sq * sk, sk});
}
