// Kernel C: the BERT FFN sublayer on rows,
//   y = LayerNorm(x + GELU(x @ W1 + b1) @ W2 + b2) * gamma + beta.
//
// Replaces the Pallas kernel `_ffn_kernel` / `fused_ffn_step`
// (openvivqa_tpu/ops/decode_step.py), which keeps the (rows, d_ff) hidden in VMEM.
//
// On the H100 the encode shapes (64 samples x ~215 rows x 768 -> 3072 -> 768) are
// bound by the tensor cores: ~2 * 2 * rows * 768 * 3072 FLOPs against ~10 MB of
// bf16 weights (counted from the shapes).  The decode shape (64 rows) is bound by
// reading the weights once.  Two launches of common.cu's blocks:
//   1. GEMM + b1 + exact-erf GELU, written as bf16 (the operand type of the second
//      product, as in the TPU kernel): the hidden makes one round trip through
//      device memory, rows * d_ff * 2 bytes each way;
//   2. GEMM + b2 + residual + LayerNorm in one pass, each block owning whole rows
//      so the LayerNorm never leaves shared memory.
// Keeping the hidden on chip (a split-K of the second product over d_ff slices
// held in shared memory) and wgmma/TMA pipelining are left for later work.
#include "common.cuh"

extern "C" int ovq_ffn_forward(const float* x, const ovq::bf16* w1, const float* b1,
                               const ovq::bf16* w2, const float* b2, const float* gamma,
                               const float* beta, ovq::bf16* hidden, float* partial, float* y,
                               int rows, int hd, int d_ff, int splits, int k_per_split, float eps,
                               cudaStream_t stream) {
  cudaError_t err = ovq::launch_gemm_bias<float, ovq::bf16, ovq::kGelu>(
      x, hd, w1, b1, hidden, d_ff, rows, d_ff, hd, stream);
  if (err != cudaSuccess) return err;
  return ovq::launch_gemm_residual_ln<ovq::bf16>(hidden, d_ff, w2, b2, x, gamma, beta, y,
                                                 partial, splits, k_per_split, rows, hd, d_ff,
                                                 eps, stream);
}
