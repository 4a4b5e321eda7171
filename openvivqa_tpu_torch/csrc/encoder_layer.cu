// Kernel F: the whole post-LN self-attention sublayer of an eval encode with a
// key-only padding bias,
//   y = LayerNorm(x + Attn(x Wq + bq, x Wk + bk, x Wv + bv; key_bias) Wo + bo).
//
// Replaces the Pallas kernel `_enc_attn_kernel` / `fused_encoder_self_attention`
// (openvivqa_tpu/ops/encoder_layer.py).  The TPU version pads every sample to a
// multiple of 8 rows and packs samples block-diagonally into one grid cell, which
// lets a sample whose keys are all masked attend to other samples' values.  Here
// every attention block belongs to one sample and reads only that sample's keys,
// so such a sample attends uniformly over its own keys, as the XLA path does.
//
// On the H100 the projections (4 * rows * 768^2 MACs, ~63 GFLOP at the MMT
// context encode, counted from the shapes) are tensor-core work and take most of
// the time; the attention itself is small (S ~ 210 keys).  Four launches:
//   1. x rounded to bf16, the A operand of the TMA-fed GEMM;
//   2. one GEMM (gemm_sm90.cu) for the packed q|k|v projection, stored as bf16
//      (rows, 3 * hd), the dot operand type of the TPU kernel;
//   3. block B's bf16 instance (fused_attention.cu): one block per (sample, head)
//      reads that head's q, k and v from the packed rows through a row stride of
//      3 * hd, K and V resident in shared memory (or a two-slot ring), and
//      writes the context as bf16 (rows, hd), the operand of the out projection;
//   4. the out projection + bias + residual + LayerNorm (gemm_sm90.cu), over a
//      cluster of CTAs that spans each row, or K split at few rows.
// q|k|v and the context round-trip through device memory (rows * hd * 8 bytes in
// all); keeping them on chip is for later work.
#include "common.cuh"

extern "C" int ovq_encoder_attention_forward(
    const float* x, const ovq::bf16* wqkv, const float* bqkv, const ovq::bf16* wo,
    const float* bo, const float* gamma, const float* beta, const float* key_bias, ovq::bf16* xb,
    ovq::bf16* qkv, ovq::bf16* ctx, float* partial, float* y, int batch, int seq, int hd,
    int heads, int resident, int bm1, int bn1, int splits1, int k_slice1, int cluster1, int bm2,
    int bn2, int splits2, int k_slice2, int cluster2, float scale, float eps,
    cudaStream_t stream) {
  const int rows = batch * seq;
  cudaError_t err = ovq::cast_to_bf16(x, xb, (long long)rows * hd, stream);
  if (err != cudaSuccess) return err;
  err = ovq::sm90_gemm_bias(xb, wqkv, bqkv, qkv, partial, rows, 3 * hd, hd, false,
                            ovq::GemmPlan{bm1, bn1, splits1, k_slice1, cluster1}, stream);
  if (err != cudaSuccess) return err;
  err = ovq::packed_attention_qkv(qkv, key_bias, ctx, batch, seq, hd, heads, scale, resident,
                                  stream);
  if (err != cudaSuccess) return err;
  return ovq::sm90_gemm_ln(ctx, wo, bo, x, gamma, beta, y, partial, rows, hd, hd, eps,
                           ovq::GemmPlan{bm2, bn2, splits2, k_slice2, cluster2}, stream);
}
