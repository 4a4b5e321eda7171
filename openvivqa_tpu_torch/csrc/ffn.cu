// Kernel C: the BERT FFN sublayer on rows,
//   y = LayerNorm(x + GELU(x @ W1 + b1) @ W2 + b2) * gamma + beta.
//
// Replaces the Pallas kernel `_ffn_kernel` / `fused_ffn_step`
// (openvivqa_tpu/ops/decode_step.py), which keeps the (rows, d_ff) hidden in VMEM.
//
// On the H100 the encode shapes (64 samples x ~210 rows x 768 -> 3072 -> 768) are
// bound by the tensor cores: 4 * rows * 768 * 3072 FLOPs, 127 GFLOP at 13,440
// rows, against ~10 MB of bf16 weights (counted from the shapes).  The decode
// shape (64 rows) is bound by reading the weights once.  Three launches on
// gemm_sm90.cu's wgmma + TMA core, each cut over the card by the caller's plans
// (ops/_cuda.py::gemm_plan):
//   1. x rounded to bf16 (the TMA loads copy bytes, and the TPU kernel's dot
//      operands are bf16), rows * hd * 6 bytes;
//   2. the GEMM + b1 + exact-erf GELU, written as bf16 (the operand type of the
//      second product, as in the TPU kernel): the hidden makes one round trip
//      through device memory, rows * d_ff * 2 bytes each way;
//   3. the GEMM + b2 + residual + LayerNorm, the LayerNorm over a cluster of
//      CTAs that spans each row, or at few rows K split over the card and the
//      LayerNorm in a second pass.
// With split plans the two products share `partial` (the larger of their
// splits * rows * N floats).
#include "common.cuh"

extern "C" int ovq_ffn_forward(const float* x, const ovq::bf16* w1, const float* b1,
                               const ovq::bf16* w2, const float* b2, const float* gamma,
                               const float* beta, ovq::bf16* xb, ovq::bf16* hidden,
                               float* partial, float* y, int rows, int hd, int d_ff, int bm1,
                               int bn1, int splits1, int k_slice1, int cluster1, int bm2, int bn2,
                               int splits2, int k_slice2, int cluster2, float eps,
                               cudaStream_t stream) {
  cudaError_t err = ovq::cast_to_bf16(x, xb, (long long)rows * hd, stream);
  if (err != cudaSuccess) return err;
  err = ovq::sm90_gemm_bias(xb, w1, b1, hidden, partial, rows, d_ff, hd, true,
                            ovq::GemmPlan{bm1, bn1, splits1, k_slice1, cluster1}, stream);
  if (err != cudaSuccess) return err;
  return ovq::sm90_gemm_ln(hidden, w2, b2, x, gamma, beta, y, partial, rows, hd, d_ff, eps,
                           ovq::GemmPlan{bm2, bn2, splits2, k_slice2, cluster2}, stream);
}
