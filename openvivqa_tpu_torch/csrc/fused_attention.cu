// Packed attention: softmax(scale * Q K^T + bias) V on the raw (b, S, heads * d)
// projections, all heads of a sample in one launch, forward only.
//
// Replaces the Pallas kernel `_packed_kernel` / `fused_attention_packed`
// (openvivqa_tpu/ops/fused_attention.py).  As there, the dot operands are rounded
// to bf16, the row softmax is f32 and the softmax weights are rounded to bf16
// before the product with V.  The bias is (bb, bq, Sk) with bb in {1, b} and
// bq in {1, Sq}; a batch-shared or row-shared bias is read through a stride of 0
// and never broadcast in device memory.
//
// On the H100, at the MMT joint encode (64 x 8 heads x ~215 x ~215, head dim 96),
// the work is small (~4.5 GFLOP, counted from the shapes): what bounds it is
// feeding the tensor cores from shared memory and keeping enough blocks resident.
// Q K^T and P V run on the tensor cores (wmma), and K and V stream through
// shared memory in 64-key chunks, ~60 KB per block whatever the key count, so
// several blocks share an SM.  To round the normalised weights to bf16, as the
// TPU kernel does, it walks the chunks twice (row max and denominator first,
// then the weights and P V), computing Q K^T twice.
#include "common.cuh"

extern "C" int ovq_packed_attention_forward(const float* q, const float* k, const float* v,
                                            const float* bias, long long bias_bs, int bias_qs,
                                            float* out, int batch, int sq, int sk, int hd,
                                            int heads, float scale, cudaStream_t stream) {
  const int d = hd / heads;
  return ovq::launch_attention<float, float>(q, (long long)sq * hd, hd, k, v, (long long)sk * hd,
                                             hd, bias, bias_bs, bias_qs, out,
                                             (long long)sq * hd, hd, batch, heads, sq, sk, d,
                                             scale, stream);
}
