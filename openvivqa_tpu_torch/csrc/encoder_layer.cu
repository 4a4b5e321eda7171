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
// On the H100 the projections (4 * rows * 768^2 MACs, ~65 GFLOP at the MMT
// context encode, counted from the shapes) are tensor-core work and take most of the time; the attention
// itself is small (S ~ 220 keys).  Three launches of common.cu's blocks:
//   1. one GEMM for the packed q|k|v projection, stored as bf16 (the dot operand
//      type of the TPU kernel);
//   2. the attention, one block per (64-row q-tile, head, sample) with keys
//      streamed in 64-row chunks, context stored as bf16 (the operand type of
//      the out projection);
//   3. the out projection + bias + residual + LayerNorm, blocks owning whole rows
//      (K split over more blocks when there are few rows, as for the question).
// q|k|v and the context round-trip through device memory (rows * 768 * 8 bytes in
// all); fusing them on chip is for later work.
#include "common.cuh"

extern "C" int ovq_encoder_attention_forward(const float* x, const ovq::bf16* wqkv,
                                             const float* bqkv, const ovq::bf16* wo,
                                             const float* bo, const float* gamma,
                                             const float* beta, const float* key_bias,
                                             ovq::bf16* qkv, ovq::bf16* ctx, float* partial,
                                             float* y, int batch, int seq, int hd, int heads,
                                             int splits, int k_per_split, float scale, float eps,
                                             cudaStream_t stream) {
  const int rows = batch * seq;
  const int d = hd / heads;
  cudaError_t err = ovq::launch_gemm_bias<float, ovq::bf16, ovq::kNone>(x, hd, wqkv, bqkv, qkv,
                                                                       3 * hd, rows, 3 * hd, hd,
                                                                       stream);
  if (err != cudaSuccess) return err;
  const long long qkv_bs = (long long)seq * 3 * hd;
  err = ovq::launch_attention<ovq::bf16, ovq::bf16>(
      qkv, qkv_bs, 3 * hd, qkv + hd, qkv + 2 * hd, qkv_bs, 3 * hd, key_bias, seq, 0, ctx,
      (long long)seq * hd, hd, batch, heads, seq, seq, d, scale, stream);
  if (err != cudaSuccess) return err;
  return ovq::launch_gemm_residual_ln<ovq::bf16>(ctx, hd, wo, bo, x, gamma, beta, y, partial,
                                                 splits, k_per_split, rows, hd, hd, eps, stream);
}
