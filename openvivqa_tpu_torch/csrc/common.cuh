// Shared pieces of the port's hand-written Hopper kernels (built for sm_90a).
//
// Device helpers are inline here; the three building blocks the kernels are
// assembled from live in common.cu and are reached through the launchers
// declared below:
//   * launch_gemm_bias:        Y = epi(A @ W + bias), bf16 wmma tiles, f32 accumulators;
//   * launch_gemm_residual_ln: Y = LayerNorm(R + A @ W + bias), one block owns whole rows
//                              so the LayerNorm runs in the GEMM's epilogue;
//   * launch_attention:        softmax(scale * Q K^T + bias) V per (sample, head, q-tile)
//                              on packed (rows, heads * head_dim) layouts.
// Every launcher returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ovq {

using bf16 = __nv_bfloat16;

enum Epilogue { kNone = 0, kGelu = 1 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// exact-erf GELU (torch.nn.functional.gelu's default)
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// Y[M, N] (row stride ldy) = epi(A[M, K] (row stride lda) @ W[K, N] + bias[N]).
// A is rounded to bf16 as it is staged; W is bf16 (K, N) row-major.  K must be a
// multiple of 32, N, ldy multiples of 8 and lda a multiple of 4.
template <typename TA, typename TO, int EPI>
cudaError_t launch_gemm_bias(const TA* A, int lda, const bf16* W, const float* bias, TO* Y,
                             int ldy, int M, int N, int K, cudaStream_t stream);

// Y[M, N] = LayerNorm(R[M, N] + A[M, K] @ W[K, N] + bias[N]) * gamma + beta, with N a
// multiple of 128 up to 1024.  R and Y are f32 with row stride N.  With splits > 1
// the K range is cut into slices of k_per_split (a multiple of 32), each block
// writes its partial rows to `partial` (splits * M * N f32) and a second launch
// sums them and runs the epilogue.
template <typename TA>
cudaError_t launch_gemm_residual_ln(const TA* A, int lda, const bf16* W, const float* bias,
                                    const float* R, const float* gamma, const float* beta,
                                    float* Y, float* partial, int splits, int k_per_split,
                                    int M, int N, int K, float eps, cudaStream_t stream);

// out[b, i, h*d + c] = sum_j w_ij v[b, j, h*d + c] with
// w_ij = bf16(softmax_j(scale * q_i . k_j + bias[b, i, j])); q, k, v rounded to bf16.
// sk must be positive and d a multiple of 16 up to 128; row and batch strides
// multiples of 4 (of 8 for out).
// q/k/v/out rows are addressed as base + b * batch_stride + row * row_stride + h * d;
// the bias as bias + b * bias_bs + i * bias_qs + j (strides of 0 broadcast).
template <typename TI, typename TO>
cudaError_t launch_attention(const TI* q, long long q_bs, int q_rs, const TI* k, const TI* v,
                             long long kv_bs, int kv_rs, const float* bias, long long bias_bs,
                             int bias_qs, TO* out, long long out_bs, int out_rs, int batch,
                             int heads, int sq, int sk, int d, float scale, cudaStream_t stream);

}  // namespace ovq
