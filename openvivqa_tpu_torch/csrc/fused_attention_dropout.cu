// Packed attention with in-kernel dropout on the attention weights, forward and
// backward, on the raw (b, S, heads * d) projections:
//   out = (keep * softmax(scale * Q K^T + bias) / (1 - rate)) V   per head.
//
// Replaces the Pallas kernels `_packed_dropout_kernel` and
// `_packed_dropout_bwd_kernel` (openvivqa_tpu/ops/fused_attention.py,
// fused_attention_packed_dropout).  As there, dot operands are bf16, the dropped
// weights are rounded to bf16 before P V, sums and the softmax are f32, and the
// backward regenerates the mask instead of reading it.  The TPU's hardware
// PRNG cannot be reproduced, so the mask comes from Philox4x32-10 counted by
// the absolute (key column / 4, query row, head, sample) position
// (common.cuh): forward and both backward kernels tile differently and draw
// the same mask.
//
// The forward is the attention block of common.cu with its dropout variant: it
// also writes each row's softmax (max, denominator), so the backward does not
// recompute them.  On the TPU the backward accumulated dk and dv across a
// sequential q-block grid dimension; blocks on the card run in no order, so
// the backward is two kernels (FlashAttention-2's split):
//   * dq: one block per (64-row q-tile, head, sample) walks the key chunks
//     twice: D_i = sum_j p_ij keep_ij (g_i . v_j) first, then
//     dS = p (keep (G V^T) - D) rounded to bf16 and dq += dS K;
//   * dk, dv: one block per (64-key tile, head, sample) walks the query chunks
//     once, with S^T = K Q^T and dP^T = V G^T, dv += bf16(p keep)^T G and
//     dk += dS^T Q.
// At the MMT training shape (64 x 8 heads x 215 x 215, head dim 96) the work
// is ~2.3 GFLOP forward and ~4.6 backward: small next to what the tensor cores
// could do, so what bounds these kernels is shared-memory traffic, the
// recomputed products (Q K^T four times, G V^T three times) and Philox's
// integer work, not device memory.
#include <mma.h>

#include "common.cuh"

namespace ovq {

using namespace nvcuda;

constexpr int kLdt = kAttnKeyChunk + 4;  // f32 row stride of a warp's 16 x 64 tile
constexpr int kLdh = kAttnKeyChunk + 8;  // bf16 row stride of a warp's 16 x 64 tile

// four 64-row bf16 tiles, two f32 and two bf16 16 x 64 tiles per warp, the
// per-warp output staging and 3 x 64 row values
template <int DF>
constexpr size_t bwd_smem_bytes() {
  return 4ull * 64 * (16 * DF + 8) * 2 + 2ull * kAttnWarps * 16 * kLdt * 4 +
         2ull * kAttnWarps * 16 * kLdh * 2 + kAttnWarps * 256 * 4 + 3 * 64 * 4;
}

struct BwdSmem {
  bf16 *t0, *t1, *t2, *t3;  // 64-row tiles
  float *s, *dp;            // this warp's f32 16 x 64 tiles
  bf16 *h0, *h1;            // this warp's bf16 16 x 64 tiles
  float* stage;             // this warp's 16 x 16 output staging
  float* rows;              // 3 x 64 row values
};

template <int DF>
__device__ __forceinline__ BwdSmem carve(unsigned char* smem, int warp) {
  constexpr int ldq = 16 * DF + 8;
  BwdSmem m;
  m.t0 = reinterpret_cast<bf16*>(smem);
  m.t1 = m.t0 + 64 * ldq;
  m.t2 = m.t1 + 64 * ldq;
  m.t3 = m.t2 + 64 * ldq;
  float* f = reinterpret_cast<float*>(m.t3 + 64 * ldq);
  m.s = f + warp * 16 * kLdt;
  m.dp = f + (kAttnWarps + warp) * 16 * kLdt;
  bf16* h = reinterpret_cast<bf16*>(f + 2 * kAttnWarps * 16 * kLdt);
  m.h0 = h + warp * 16 * kLdh;
  m.h1 = h + (kAttnWarps + warp) * 16 * kLdh;
  float* after = reinterpret_cast<float*>(h + 2 * kAttnWarps * 16 * kLdh);
  m.stage = after + warp * 256;
  m.rows = after + kAttnWarps * 256;
  return m;
}

// out (16 x 64, stride kLdt) = A (16 x d, fragments) @ B^T where B is 64 rows
// of d (bf16, stride ldq): four 16-column fragments
template <int DF>
__device__ __forceinline__ void rows_times_tile_t(
    float* out, const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>* a,
    const bf16* tile) {
  constexpr int ldq = 16 * DF + 8;
#pragma unroll
  for (int j = 0; j < kAttnKeyChunk / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DF; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, tile + (16 * j) * ldq + 16 * kk, ldq);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + 16 * j, acc, kLdt, wmma::mem_row_major);
  }
}

// acc (16 x d) += P (16 x 64 bf16, stride kLdh) @ tile (64 rows of d)
template <int DF>
__device__ __forceinline__ void accumulate_p_tile(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* p, const bf16* tile) {
  constexpr int ldq = 16 * DF + 8;
#pragma unroll
  for (int kk = 0; kk < kAttnKeyChunk / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
    wmma::load_matrix_sync(pf, p + 16 * kk, kLdh);
#pragma unroll
    for (int j = 0; j < DF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, tile + (16 * kk) * ldq + 16 * j, ldq);
      wmma::mma_sync(acc[j], pf, bf, acc[j]);
    }
  }
}

// 16 rows x d of accumulators * factor -> f32 rows (row r at out + r * rs)
template <int DF>
__device__ __forceinline__ void store_rows(const wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
                                           float* stage, float* out, long long rs, int valid_rows,
                                           float factor, int lane) {
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int j = 0; j < DF; ++j) {
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (r < valid_rows) {
      float vals[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) vals[u] = stage[r * 16 + c8 + u] * factor;
      store_eight(out + r * rs + 16 * j + c8, vals);
    }
    __syncwarp();
  }
}

// -- dq and the row terms D ----------------------------------------------------
template <int DF>
__global__ void __launch_bounds__(kAttnThreads)
    dropout_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ bias, long long bias_bs, int bias_qs,
                      Dropout drop, float* __restrict__ delta, float* __restrict__ dq, int sq,
                      int sk, int hd, float scale) {
  constexpr int d = 16 * DF;
  constexpr int ldq = d + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const BwdSmem m = carve<DF>(smem, warp);
  bf16 *Qs = m.t0, *Gs = m.t1, *Ks = m.t2, *Vs = m.t3;

  const int b = blockIdx.z, h = blockIdx.y, heads = gridDim.y, i0 = blockIdx.x * kAttnQTile;
  const int w0 = 16 * warp;
  const bool active = i0 + w0 < sq;
  const long long q_bs = (long long)sq * hd, kv_bs = (long long)sk * hd;
  stage_rows<DF>(Qs, ldq, q + b * q_bs + (long long)i0 * hd + h * d, hd, sq - i0);
  stage_rows<DF>(Gs, ldq, g + b * q_bs + (long long)i0 * hd + h * d, hd, sq - i0);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DF], gf[DF];
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + w0 * ldq + 16 * kk, ldq);
    wmma::load_matrix_sync(gf[kk], Gs + w0 * ldq + 16 * kk, ldq);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DF];
#pragma unroll
  for (int j = 0; j < DF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // lanes 2r and 2r + 1 own row r of the warp's 16, 32 columns of each chunk apiece
  const int sr = lane / 2, half = lane % 2;
  const int si = i0 + w0 + sr;
  const bool row_ok = si < sq;
  const float* brow = bias + b * bias_bs + (long long)(row_ok ? si : 0) * bias_qs;
  const long long row_index = ((long long)b * heads + h) * sq + (row_ok ? si : 0);
  const float row_max = drop.stats[row_index * 2], row_sum = drop.stats[row_index * 2 + 1];
  const unsigned long long seed = (unsigned long long)*drop.seed;
  const float* kb = k + b * kv_bs + h * d;
  const float* vb = v + b * kv_bs + h * d;
  float dsum = 0.0f, row_d = 0.0f;

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
    for (int j0 = 0; j0 < sk; j0 += kAttnKeyChunk) {
      __syncthreads();  // the previous chunk is no longer read
      stage_rows<DF>(Ks, ldq, kb + (long long)j0 * hd, hd, sk - j0);
      stage_rows<DF>(Vs, ldq, vb + (long long)j0 * hd, hd, sk - j0);
      __syncthreads();
      if (!active) continue;
      rows_times_tile_t<DF>(m.s, qf, Ks);
      rows_times_tile_t<DF>(m.dp, gf, Vs);
      __syncwarp();
      const float* srow = m.s + sr * kLdt;
      const float* prow = m.dp + sr * kLdt;
      bf16* hrow = m.h0 + sr * kLdh;
#pragma unroll
      for (int u = 0; u < 32; u += 4) {
        float factors[4];
        dropout_factors(drop, seed, (j0 + half * 32 + u) / 4, si, h, b, factors);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = half * 32 + u + t;
          const bool valid = row_ok && j0 + c < sk;
          const float p =
              valid ? expf(srow[c] * scale + brow[j0 + c] - row_max) / row_sum : 0.0f;
          const float dw = prow[c] * factors[t];
          if (pass == 0)
            dsum += p * dw;
          else
            hrow[c] = __float2bfloat16(p * (dw - row_d));
        }
      }
      __syncwarp();
      if (pass == 1) accumulate_p_tile<DF>(acc, m.h0, Ks);
    }
    if (pass == 0) row_d = dsum + __shfl_xor_sync(0xffffffffu, dsum, 1);
  }
  if (!active) return;
  if (row_ok && half == 0) delta[row_index] = row_d;
  store_rows<DF>(acc, m.stage, dq + b * q_bs + (long long)(i0 + w0) * hd + h * d, hd,
                 sq - (i0 + w0), scale, lane);
}

// -- dk and dv -------------------------------------------------------------------
template <int DF>
__global__ void __launch_bounds__(kAttnThreads)
    dropout_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ bias, long long bias_bs, int bias_qs,
                        Dropout drop, const float* __restrict__ delta, float* __restrict__ dk,
                        float* __restrict__ dv, int sq, int sk, int hd, float scale) {
  constexpr int d = 16 * DF;
  constexpr int ldq = d + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const BwdSmem m = carve<DF>(smem, warp);
  bf16 *Ks = m.t0, *Vs = m.t1, *Qs = m.t2, *Gs = m.t3;
  float* row_max = m.rows;
  float* row_sum = m.rows + 64;
  float* row_d = m.rows + 128;

  const int b = blockIdx.z, h = blockIdx.y, heads = gridDim.y, j0 = blockIdx.x * kAttnKeyChunk;
  const int w0 = 16 * warp;
  const bool active = j0 + w0 < sk;
  const long long q_bs = (long long)sq * hd, kv_bs = (long long)sk * hd;
  stage_rows<DF>(Ks, ldq, k + b * kv_bs + (long long)j0 * hd + h * d, hd, sk - j0);
  stage_rows<DF>(Vs, ldq, v + b * kv_bs + (long long)j0 * hd + h * d, hd, sk - j0);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> kf[DF], vf[DF];
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) {
    wmma::load_matrix_sync(kf[kk], Ks + w0 * ldq + 16 * kk, ldq);
    wmma::load_matrix_sync(vf[kk], Vs + w0 * ldq + 16 * kk, ldq);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[DF], dv_acc[DF];
#pragma unroll
  for (int j = 0; j < DF; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }

  // lanes 2r and 2r + 1 own key r of the warp's 16, 32 query columns apiece
  const int sr = lane / 2, half = lane % 2;
  const int sj = j0 + w0 + sr;
  const bool key_ok = sj < sk;
  const float* bcol = bias + b * bias_bs + (key_ok ? sj : 0);
  const unsigned long long seed = (unsigned long long)*drop.seed;
  const long long rows0 = ((long long)b * heads + h) * sq;
  const float* qb = q + b * q_bs + h * d;
  const float* gb = g + b * q_bs + h * d;

#pragma unroll 1
  for (int i0 = 0; i0 < sq; i0 += kAttnQTile) {
    __syncthreads();  // the previous chunk is no longer read
    stage_rows<DF>(Qs, ldq, qb + (long long)i0 * hd, hd, sq - i0);
    stage_rows<DF>(Gs, ldq, gb + (long long)i0 * hd, hd, sq - i0);
    for (int t = threadIdx.x; t < kAttnQTile; t += kAttnThreads) {
      const bool ok = i0 + t < sq;
      const long long row = rows0 + (ok ? i0 + t : 0);
      row_max[t] = ok ? drop.stats[row * 2] : 0.0f;
      row_sum[t] = ok ? drop.stats[row * 2 + 1] : 1.0f;
      row_d[t] = ok ? delta[row] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    rows_times_tile_t<DF>(m.s, kf, Qs);  // S^T: keys x queries
    rows_times_tile_t<DF>(m.dp, vf, Gs);
    __syncwarp();
    const float* srow = m.s + sr * kLdt;
    const float* prow = m.dp + sr * kLdt;
    bf16* pd_row = m.h0 + sr * kLdh;
    bf16* ds_row = m.h1 + sr * kLdh;
#pragma unroll 4
    for (int u = 0; u < 32; ++u) {
      const int c = half * 32 + u, i = i0 + c;
      const bool valid = key_ok && i < sq;
      const float factor = dropout_factor(drop, seed, sj, valid ? i : 0, h, b);
      const float p = valid ? expf(srow[c] * scale + bcol[(long long)i * bias_qs] - row_max[c]) /
                                  row_sum[c]
                            : 0.0f;
      pd_row[c] = __float2bfloat16(p * factor);
      ds_row[c] = __float2bfloat16(p * (prow[c] * factor - row_d[c]));
    }
    __syncwarp();
    accumulate_p_tile<DF>(dv_acc, m.h0, Gs);
    accumulate_p_tile<DF>(dk_acc, m.h1, Qs);
  }
  if (!active) return;
  const long long out0 = b * kv_bs + (long long)(j0 + w0) * hd + h * d;
  store_rows<DF>(dk_acc, m.stage, dk + out0, hd, sk - (j0 + w0), scale, lane);
  store_rows<DF>(dv_acc, m.stage, dv + out0, hd, sk - (j0 + w0), 1.0f, lane);
}

template <int DF>
static cudaError_t launch_backward(const float* q, const float* k, const float* v, const float* g,
                                   const float* bias, long long bias_bs, int bias_qs,
                                   Dropout drop, float* delta, float* dq, float* dk, float* dv,
                                   int batch, int sq, int sk, int hd, int heads, float scale,
                                   cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<DF>();
  cudaError_t err = cudaFuncSetAttribute(dropout_dq_kernel<DF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dropout_dkdv_kernel<DF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dropout_dq_kernel<DF><<<dim3((sq + kAttnQTile - 1) / kAttnQTile, heads, batch), kAttnThreads,
                          smem, stream>>>(q, k, v, g, bias, bias_bs, bias_qs, drop, delta, dq,
                                          sq, sk, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dropout_dkdv_kernel<DF><<<dim3((sk + kAttnKeyChunk - 1) / kAttnKeyChunk, heads, batch),
                            kAttnThreads, smem, stream>>>(q, k, v, g, bias, bias_bs, bias_qs,
                                                          drop, delta, dk, dv, sq, sk, hd, scale);
  return cudaGetLastError();
}

static bool shape_ok(int batch, int sq, int sk, int hd, int heads) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || hd % heads) return false;
  const int d = hd / heads;
  return d > 0 && d % 16 == 0 && d <= 128;
}

}  // namespace ovq

extern "C" int ovq_packed_dropout_forward(const float* q, const float* k, const float* v,
                                          const float* bias, long long bias_bs, int bias_qs,
                                          const long long* seed, int threshold, float keep_scale,
                                          float* stats, float* out, int batch, int sq, int sk,
                                          int hd, int heads, float scale, cudaStream_t stream) {
  if (!ovq::shape_ok(batch, sq, sk, hd, heads) || seed == nullptr || stats == nullptr)
    return cudaErrorInvalidValue;
  const ovq::Dropout drop{seed, (unsigned)threshold, keep_scale, stats};
  return ovq::launch_attention<float, float>(q, (long long)sq * hd, hd, k, v, (long long)sk * hd,
                                             hd, bias, bias_bs, bias_qs, out,
                                             (long long)sq * hd, hd, batch, heads, sq, sk,
                                             hd / heads, scale, stream, drop);
}

extern "C" int ovq_packed_dropout_backward(const float* q, const float* k, const float* v,
                                           const float* g, const float* bias, long long bias_bs,
                                           int bias_qs, const long long* seed, int threshold,
                                           float keep_scale, const float* stats, float* delta,
                                           float* dq, float* dk, float* dv, int batch, int sq,
                                           int sk, int hd, int heads, float scale,
                                           cudaStream_t stream) {
  if (!ovq::shape_ok(batch, sq, sk, hd, heads) || seed == nullptr || stats == nullptr)
    return cudaErrorInvalidValue;
  const ovq::Dropout drop{seed, (unsigned)threshold, keep_scale, const_cast<float*>(stats)};
#define OVQ_BWD_CASE(df)                                                                       \
  case df:                                                                                     \
    return ovq::launch_backward<df>(q, k, v, g, bias, bias_bs, bias_qs, drop, delta, dq, dk, dv, \
                                    batch, sq, sk, hd, heads, scale, stream);
  switch (hd / heads / 16) {
    OVQ_BWD_CASE(1)
    OVQ_BWD_CASE(2)
    OVQ_BWD_CASE(3)
    OVQ_BWD_CASE(4)
    OVQ_BWD_CASE(5)
    OVQ_BWD_CASE(6)
    OVQ_BWD_CASE(7)
    OVQ_BWD_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef OVQ_BWD_CASE
}
