// Shared pieces of the port's hand-written Hopper kernels (built for sm_90a).
//
// Device helpers are inline here; the three building blocks the kernels are
// assembled from live in common.cu and are reached through the launchers
// declared below:
//   * launch_gemm_bias:        Y = epi(A @ W + bias), bf16 wmma tiles, f32 accumulators;
//   * launch_gemm_residual_ln: Y = LayerNorm(R + A @ W + bias), one block owns whole rows
//                              so the LayerNorm runs in the GEMM's epilogue;
//   * launch_attention:        softmax(scale * Q K^T + bias [+ head_bias]) V per (sample,
//                              head, q-tile) on packed (rows, heads * head_dim) layouts.
// The mma.sync pieces below (ldmatrix operands, m16n8k16 products, bf16 packing)
// build block B (fused_attention.cu) and the dropout backward pair
// (fused_attention_dropout.cu).
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

// four consecutive values as four bf16 in a uint2 (zeros when !valid)
__device__ __forceinline__ uint2 load_quad(const float* p, bool valid) {
  const float4 v = valid ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
}
__device__ __forceinline__ uint2 load_quad(const bf16* p, bool valid) {
  return valid ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
}

// eight consecutive outputs from f32 values
__device__ __forceinline__ void store_eight(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_eight(bf16* p, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) h[u] = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<uint4*>(h);
}

// the attention blocks: 64-row tiles, 64-row key chunks, 4 warps of 16 rows
constexpr int kAttnQTile = 64;
constexpr int kAttnKeyChunk = 64;
constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;

// 64 rows x (16 * DF) values (row stride rs) -> bf16 rows of stride ld; zero
// rows from `valid_rows` on.  All of a thread's loads are issued before its
// stores.
template <int DF, typename TI>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const TI* src, long long rs,
                                           int valid_rows) {
  constexpr int quads = 4 * DF;
  constexpr int per_thread = 64 * quads / kAttnThreads;
  uint2 regs[per_thread];
#pragma unroll
  for (int u = 0; u < per_thread; ++u) {
    const int idx = threadIdx.x + u * kAttnThreads, r = idx / quads, c = (idx % quads) * 4;
    const bool valid = r < valid_rows;
    regs[u] = load_quad(src + (valid ? r : 0) * rs + c, valid);
  }
#pragma unroll
  for (int u = 0; u < per_thread; ++u) {
    const int idx = threadIdx.x + u * kAttnThreads, r = idx / quads, c = (idx % quads) * 4;
    *reinterpret_cast<uint2*>(dst + (size_t)r * ld + c) = regs[u];
  }
}

// -- single-query attention steps (kernels A, B and D) ---------------------------
// One block per (head, decode row): the query's d values sit in shared memory and
// the keys stream past in chunks of 64 under an online softmax.
constexpr int kStepChunk = 64;
constexpr int kStepThreads = 128;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepMaxHeadDim = 2 * kStepThreads;
constexpr float kMaskValue = -10e4f;  // models/modules/masks.py MASK_VALUE

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(bf16* p, float v) { *p = __float2bfloat16(v); }

// keys [0, n) of one source (float or bf16 rows of stride hd, this head's columns
// first) folded into the block's running (max m, denominator s, accumulator acc):
// logit_j = scale * q . k_j + bias_of(j).  Every thread of the block calls it;
// qs holds the query's d values, ps is kStepChunk floats of scratch, and thread
// c accumulates output columns c and c + kStepThreads.
template <typename TK, typename BiasFn>
__device__ __forceinline__ void fold_keys(const TK* keys, const TK* values, BiasFn bias_of, int n,
                                          int hd, int d, float scale, const float* qs, float* ps,
                                          float& m, float& s, float (&acc)[2]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j0 = 0; j0 < n; j0 += kStepChunk) {
    const int count = min(kStepChunk, n - j0);
    for (int jj = warp; jj < count; jj += kStepWarps) {
      const TK* krow = keys + (size_t)(j0 + jj) * hd;
      float part = 0.0f;
      for (int c = lane; c < d; c += 32) part = fmaf(qs[c], to_float(krow[c]), part);
      part = warp_sum(part);
      if (lane == 0) ps[jj] = part * scale + bias_of(j0 + jj);
    }
    __syncthreads();
    float chunk_max = -INFINITY;
    for (int jj = 0; jj < count; ++jj) chunk_max = fmaxf(chunk_max, ps[jj]);
    const float m_new = fmaxf(m, chunk_max);
    const float alpha = expf(m - m_new);
    acc[0] *= alpha;
    acc[1] *= alpha;
    float chunk_sum = 0.0f;
    for (int jj = 0; jj < count; ++jj) {
      const float p = expf(ps[jj] - m_new);
      chunk_sum += p;
      const TK* vrow = values + (size_t)(j0 + jj) * hd;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = threadIdx.x + u * kStepThreads;
        if (c < d) acc[u] = fmaf(p, to_float(vrow[c]), acc[u]);
      }
    }
    s = s * alpha + chunk_sum;
    m = m_new;
    __syncthreads();
  }
}

// Counter-based Philox4x32-10 (Salmon et al., SC'11; the generator behind
// curand's Philox4_32_10): four 32-bit words from a 128-bit counter and a
// 64-bit key.  The attention dropout keys it with the per-call seed and counts
// (key column / 4, query row, head, sample), taking word (key column % 4), so a
// mask element depends on its absolute position only, never on the tiling.  It
// keeps an element iff (word >> 9) >= threshold, threshold = min(int(rate *
// 2^23), 2^23 - 1) (the JAX package's _dropout_threshold).
// fused_attention.py::philox4x32_10 is the same function in PyTorch.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// the keep bits of the four key columns of one Philox call: bit u for word u
__device__ __forceinline__ unsigned keep_bits4(uint4 w, unsigned threshold) {
  return ((w.x >> 9) >= threshold) | ((w.y >> 9) >= threshold) << 1 |
         ((w.z >> 9) >= threshold) << 2 | ((w.w >> 9) >= threshold) << 3;
}

// -- mma.sync building blocks ------------------------------------------------------
// One warp's m16n8k16 bf16 product with f32 accumulators.  Lane (g = lane / 4,
// t = lane % 4) holds accumulator elements (row g, columns 2t, 2t + 1) in c[0],
// c[1] and (row g + 8, the same columns) in c[2], c[3]; two such tiles side by
// side are, packed to bf16, the A operand of the next product (FlashAttention-2's
// accumulator-to-operand identity).
constexpr int kMmaThreads = 256;  // blocks of 8 warps, 16 rows each
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take on the H100
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
// two 16 x 8 accumulator tiles (16 x 16) as the bf16 A operand of a product
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&s)[2][4]) {
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

// e^x for x <= 0 as exp2(x * log2 e); callers subtract the row max first, since
// near -1e5 (a masked row) a logit scaled by log2 e before it would lose the bits
// that tell its keys apart
__device__ __forceinline__ float ex2(float x) { return exp2f(x * kLog2e); }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// The A fragments of rows r0 and r1 = r0 + 8 of a f32 matrix (row stride ld,
// this head's d = 16 * DF columns from `base`), rounded to bf16; zero for rows
// at or past `rows` and when !active.
template <int DF>
__device__ __forceinline__ void load_a_rows(unsigned (&a)[DF][4], const float* base, int r0,
                                            int rows, long long ld, int t, bool active) {
  const int r1 = r0 + 8;
  const float* p0 = base + (long long)(r0 < rows ? r0 : 0) * ld + 2 * t;
  const float* p1 = base + (long long)(r1 < rows ? r1 : 0) * ld + 2 * t;
  const bool ok0 = active && r0 < rows, ok1 = active && r1 < rows;
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    const float2 z = make_float2(0.f, 0.f);
    const float2 a0 = ok0 ? *reinterpret_cast<const float2*>(p0 + 16 * kk) : z;
    const float2 a1 = ok1 ? *reinterpret_cast<const float2*>(p1 + 16 * kk) : z;
    const float2 a2 = ok0 ? *reinterpret_cast<const float2*>(p0 + 16 * kk + 8) : z;
    const float2 a3 = ok1 ? *reinterpret_cast<const float2*>(p1 + 16 * kk + 8) : z;
    a[kk][0] = pack_bf16(a0.x, a0.y);
    a[kk][1] = pack_bf16(a1.x, a1.y);
    a[kk][2] = pack_bf16(a2.x, a2.y);
    a[kk][3] = pack_bf16(a3.x, a3.y);
  }
}

// s (16 rows x 16 columns, two n-tiles) = A (16 x d fragments) times 16 rows of
// a bf16 shared-memory matrix from row `row` (stride LD), transposed: the scores
// of 16 keys, q . k, from K's rows
template <int DF, int LD>
__device__ __forceinline__ void times_rows_t(float (&s)[2][4], const unsigned (&a)[DF][4],
                                             const bf16* rows, int row, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    unsigned f[4];
    ldmatrix_x4(f, rows + (row + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + 16 * kk +
                       ((lane >> 3) & 1) * 8);
    mma_bf16(s[0], a[kk], f[0], f[1]);
    mma_bf16(s[1], a[kk], f[2], f[3]);
  }
}

// o (16 x d) += A (16 x 16) times 16 rows of a bf16 shared-memory matrix from row
// `row` (stride LD): P V over 16 keys
template <int DF, int LD>
__device__ __forceinline__ void add_times_rows(float (&o)[2 * DF][4], const unsigned (&a)[4],
                                               const bf16* rows, int row, int lane) {
#pragma unroll
  for (int n = 0; n < 2 * DF; n += 2) {
    unsigned f[4];
    ldmatrix_x4_trans(f, rows + (row + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * n +
                             ((lane >> 4) & 1) * 8);
    mma_bf16(o[n], a, f[0], f[1]);
    mma_bf16(o[n + 1], a, f[2], f[3]);
  }
}

// 16 rows x d of accumulators times `factor` to f32 rows r0 (row g) and r0 + 8 of
// `base` (row stride ld), rows at or past `rows` skipped
template <int DF>
__device__ __forceinline__ void store_acc_rows(const float (&o)[2 * DF][4], float* base, int r0,
                                               int rows, long long ld, int t, float factor) {
  float* o0 = base + (long long)r0 * ld + 2 * t;
  float* o1 = base + (long long)(r0 + 8) * ld + 2 * t;
#pragma unroll
  for (int n = 0; n < 2 * DF; ++n) {
    if (r0 < rows)
      *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(o[n][0] * factor, o[n][1] * factor);
    if (r0 + 8 < rows)
      *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(o[n][2] * factor, o[n][3] * factor);
  }
}

// A second additive bias with a head axis (T5's relative positions, DeBERTa's
// disentangled terms), added after the head-shared one: element (b, h, i, j)
// at p + b * bs + h * hs + i * qs + j.  A stride of 0 shares it, so a table
// shared by the samples (bs = 0) is read, never broadcast in device memory.
struct HeadBias {
  const float* p;
  long long bs;
  long long hs;
  int qs;
};

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
// With head_bias.p set (float in and out), the logit is scale * q_i . k_j +
// bias[b, i, j] + head_bias[b, h, i, j].
template <typename TI, typename TO>
cudaError_t launch_attention(const TI* q, long long q_bs, int q_rs, const TI* k, const TI* v,
                             long long kv_bs, int kv_rs, const float* bias, long long bias_bs,
                             int bias_qs, TO* out, long long out_bs, int out_rs, int batch,
                             int heads, int sq, int sk, int d, float scale, cudaStream_t stream,
                             HeadBias head_bias = HeadBias{nullptr, 0, 0, 0});

}  // namespace ovq
