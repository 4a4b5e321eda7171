// Streamed packed attention: softmax(scale * Q K^T + bias) V on the raw (b, S,
// heads * d) projections over a key stream of any length, forward only.
//
// Replaces the Pallas kernel `_streamed_kernel` / `fused_attention_packed_streamed`
// (openvivqa_tpu/ops/fused_attention.py), which the JAX package takes where the
// packed kernel's whole-key blocks no longer fit the TPU's VMEM (from 1536 keys at
// hd 512, from 1024 at hd 768).  The TPU kernel walks key blocks that must divide
// Sk over a sequential grid axis, carrying (max, sum, acc) in scratch.
//
// On the H100 nothing of that plan is needed: the packed attention's block
// (common.cu) already streams keys through shared memory in 64-key chunks, with a
// count for the ragged end, so its footprint (~60 KB at head dim 64) does not grow
// with Sk.  This entry is that device code behind its own entry and launch
// counter, as kernel E is kernel B's.  At 64 samples x 1536 keys x hd 512 over 8
// heads the work is ~310 GFLOP against ~0.8 GB of float32 q, k, v and output, so
// the tensor cores bound it; the block computes Q K^T twice (row max and
// denominator first, then the normalised weights rounded to bf16 and P V) and
// uses wmma (mma.sync), not wgmma.  What would serve long streams with few query
// tiles better is splitting the keys over several blocks with a combine pass.
#include "common.cuh"

extern "C" int ovq_streamed_attention_forward(const float* q, const float* k, const float* v,
                                              const float* bias, long long bias_bs, int bias_qs,
                                              float* out, int batch, int sq, int sk, int hd,
                                              int heads, float scale, cudaStream_t stream) {
  const int d = hd / heads;
  return ovq::launch_attention<float, float>(q, (long long)sq * hd, hd, k, v, (long long)sk * hd,
                                             hd, bias, bias_bs, bias_qs, out,
                                             (long long)sq * hd, hd, batch, heads, sq, sk, d,
                                             scale, stream);
}
