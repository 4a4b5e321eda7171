// Flat attention: softmax(scale * q k^T + bias) v per (sample, head) on split-head
// operands, forward only.  Two device blocks, chosen by ops/fused_attention.py's
// attention_block from the shapes alone: the single-query block (block A) for a
// few query rows per (sample, head), and the 64-row tile block past that.
//
// Replaces the Pallas kernel `_flat_kernel` / `_fused_attention_flat`
// (openvivqa_tpu/ops/fused_attention.py), one TPU grid cell per (sample, head)
// holding the whole (Sq, Sk) logits tile in VMEM.  As there, the dot operands are
// rounded to bf16, the logits and the row softmax are f32, each row's max and
// denominator are taken over all its keys before its weights are rounded to bf16,
// and P v is summed in f32.  Unlike there, v may have another head dim than q
// and k (the TPU kernel reshapes v to q's width and cannot).
//
// q is (b, h, Sq, d_k), k (b, h, Sk, d_k), v (b, h, Sk, d_v) and out (b, h, Sq, d_v),
// each read or written through its own (batch, head, row) strides with a unit
// stride on the last axis, so head-split views of packed (b, S, h * d) projections
// pass as they are (the packed entry reaches block A this way, with head stride
// d and row stride h * d).  The bias is read per logit through (batch, head, row,
// key) strides, 0 over any broadcast axis: a constant, a key-padding bias, a
// per-sample or a per-head one, or a decode ring's (rows, 1, 1, T) bias, never
// broadcast in device memory; or none (a null pointer).  A row
// whose keys are all masked (bias -1e5) gets the average of its values, finite.
//
// Block A (single_query_kernel).  At JointTransformer's beam-eval decode steps
// (60 rows x 8 heads x 1 query x 324 keys, d 64, float32 K and V) the work is a
// matrix-vector product per (sample, head): 2 FLOP per 8 bytes of K or V, so the
// bytes bound it (79.9 MB, 0.024 ms at 3.35 TB/s), and what matters is keeping
// enough loads in flight and reading each key and value once.  One block of 8
// warps per (sample, head), 480 blocks at that step, all resident at once.  Lane
// groups of 8 each read one key row with 16-byte loads, four rows in flight per
// group, round it to bf16 and dot it in f32 FMAs with the bf16-rounded query row
// held in registers; the group's sum is reduced by shuffles and scale * dot
// lands in a shared-memory row of Sk floats.  The block then adds the bias
// (coalesced, one key per thread), takes the max and the denominator by shuffles
// and shared memory, and overwrites the row with the normalised weights rounded
// to bf16.  A second walk reads V the same way, each warp accumulating a partial
// d_v vector; the eight partials are summed in shared memory and written in (b,
// Sq, h, d_v) order.  More query rows (up to the cut-over) loop inside the block,
// re-reading K and V through the cache.
//
// The tile block (flat_attention_kernel) is the packed attention's first block
// (since retired) with head strides and two head dims: one block per (64-row q-tile,
// head, sample), 4 warps of 16 query rows, keys and values streamed through
// shared memory in 64-key chunks (zero rows past Sk, zero columns past d_k or
// d_v, so one template of width 16 * ceil(max(d_k, d_v) / 16) serves both), Q
// K^T and P V on the tensor cores (wmma bf16, f32 accumulators), two passes so
// the weights are normalised before they are rounded.  At one query row it
// would run one valid row of its 64-row tile, which is why block A exists.
#include <mma.h>

#include <stdint.h>

#include "common.cuh"

namespace ovq {
namespace {

using namespace nvcuda;

__device__ const float kZeroBias = 0.0f;  // the tile block's bias where there is none

struct FlatIn {
  const float* p;
  long long bs, hs;
  int rs;
};
struct FlatOut {
  float* p;
  long long bs, hs;
  int rs;
};
struct FlatBias {
  const float* p;
  long long bs, hs;
  int qs, ks;
};

// 64 rows x (16 * DF) columns of one (sample, head) slice, row stride rs, ->
// bf16 rows of stride ld; rows from valid_rows on and columns from `cols` (a
// multiple of 4) on are zero.  All of a thread's loads are issued before its stores.
template <int DF>
__device__ __forceinline__ void stage_slice(bf16* dst, int ld, const float* src, int rs,
                                            int valid_rows, int cols) {
  constexpr int quads = 4 * DF;
  constexpr int per_thread = kAttnQTile * quads / kAttnThreads;
  uint2 regs[per_thread];
#pragma unroll
  for (int u = 0; u < per_thread; ++u) {
    const int idx = threadIdx.x + u * kAttnThreads, r = idx / quads, c = (idx % quads) * 4;
    const bool valid = r < valid_rows && c < cols;
    regs[u] = load_quad(src + (valid ? (long long)r * rs + c : 0), valid);
  }
#pragma unroll
  for (int u = 0; u < per_thread; ++u) {
    const int idx = threadIdx.x + u * kAttnThreads, r = idx / quads, c = (idx % quads) * 4;
    *reinterpret_cast<uint2*>(dst + (size_t)r * ld + c) = regs[u];
  }
}

long long flat_smem_bytes(int df) {
  const int d = 16 * df;
  return (kAttnQTile + 2 * kAttnKeyChunk) * (d + 8) * 2LL   // Q tile, K and V chunks
         + kAttnWarps * 16 * (kAttnKeyChunk + 4) * 4LL      // per-warp score chunk
         + kAttnWarps * 256 * 4LL;                          // per-warp output staging
}

template <int DF>
__global__ void __launch_bounds__(kAttnThreads)
    flat_attention_kernel(FlatIn q, FlatIn k, FlatIn v, FlatBias bias, FlatOut out, int sq,
                          int sk, int dk, int dv, float scale) {
  constexpr int d = 16 * DF;
  constexpr int ldq = d + 8;
  constexpr int lds = kAttnKeyChunk + 4;  // f32 score row stride
  constexpr int ldp = 2 * lds;            // bf16 weight row stride (same bytes)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kAttnQTile * ldq;
  bf16* Vs = Ks + kAttnKeyChunk * ldq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(Vs + kAttnKeyChunk * ldq) + warp * 16 * lds;
  float* stage = reinterpret_cast<float*>(Vs + kAttnKeyChunk * ldq) +
                 kAttnWarps * 16 * lds + warp * 256;

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kAttnQTile;
  const int w0 = 16 * warp;          // this warp's first row in the tile
  const bool active = i0 + w0 < sq;  // inactive warps still meet every barrier
  const float* kb = k.p + b * k.bs + h * k.hs;
  const float* vb = v.p + b * v.bs + h * v.hs;

  stage_slice<DF>(Qs, ldq, q.p + b * q.bs + h * q.hs + (long long)i0 * q.rs, q.rs, sq - i0, dk);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DF];
#pragma unroll
  for (int kk = 0; kk < DF; ++kk) wmma::load_matrix_sync(qf[kk], Qs + w0 * ldq + 16 * kk, ldq);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[DF];
#pragma unroll
  for (int j = 0; j < DF; ++j) wmma::fill_fragment(o[j], 0.0f);
  // softmax rows: lanes 2r and 2r + 1 own row r of the warp's 16, 32 columns of
  // each chunk apiece, and keep the row's running max and denominator
  const int sr = lane / 2, half = lane % 2;
  const int si = i0 + w0 + sr;
  const bool row_ok = si < sq;
  // no bias: every stride is 0 and each logit reads the one device zero
  const float* brow = bias.p == nullptr ? &kZeroBias
                                        : bias.p + b * bias.bs + h * bias.hs +
                                              (long long)(row_ok ? si : 0) * bias.qs;
  float row_max = -INFINITY, row_sum = 0.0f;

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
    for (int j0 = 0; j0 < sk; j0 += kAttnKeyChunk) {
      __syncthreads();  // the previous chunk is no longer read
      stage_slice<DF>(Ks, ldq, kb + (long long)j0 * k.rs, k.rs, sk - j0, dk);
      if (pass == 1) stage_slice<DF>(Vs, ldq, vb + (long long)j0 * v.rs, v.rs, sk - j0, dv);
      __syncthreads();
      if (!active) continue;

#pragma unroll
      for (int j = 0; j < kAttnKeyChunk / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
        wmma::fill_fragment(s, 0.0f);
#pragma unroll
        for (int kk = 0; kk < DF; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + (16 * j) * ldq + 16 * kk, ldq);
          wmma::mma_sync(s, qf[kk], kf, s);
        }
        wmma::store_matrix_sync(Sw + 16 * j, s, lds, wmma::mem_row_major);
      }
      __syncwarp();

      float* srow = Sw + sr * lds;
      float vals[32];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int c = half * 32 + u;
        vals[u] = row_ok && j0 + c < sk
                      ? srow[c] * scale + brow[(long long)(j0 + c) * bias.ks]
                      : -INFINITY;
        chunk_max = fmaxf(chunk_max, vals[u]);
      }
      chunk_max = fmaxf(chunk_max, __shfl_xor_sync(0xffffffffu, chunk_max, 1));
      if (pass == 0) {
        const float m_new = fmaxf(row_max, chunk_max);
        const float base = row_ok ? m_new : 0.0f;  // rows past the end stay finite
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < 32; ++u) part += expf(vals[u] - base);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (row_ok) {
          row_sum = row_sum * expf(row_max - m_new) + part;
          row_max = m_new;
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < 32; ++u) vals[u] = row_ok ? expf(vals[u] - row_max) / row_sum : 0.0f;
      __syncwarp();  // the row pair has read its scores before the weights overwrite them
      bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
      for (int u = 0; u < 32; ++u) prow[half * 32 + u] = __float2bfloat16(vals[u]);
      __syncwarp();

      const bf16* P = reinterpret_cast<const bf16*>(Sw);
#pragma unroll
      for (int kk = 0; kk < kAttnKeyChunk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::load_matrix_sync(pf, P + 16 * kk, ldp);
#pragma unroll
        for (int j = 0; j < DF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + (16 * kk) * ldq + 16 * j, ldq);
          wmma::mma_sync(o[j], pf, vf, o[j]);
        }
      }
    }
  }
  if (!active) return;

  // columns past d_v hold zeros (v's were staged as zeros) and are not written
  const int r = lane / 2, c8 = (lane % 2) * 8;
  const int i = i0 + w0 + r;
  float* orow = out.p + b * out.bs + h * out.hs + (long long)(i < sq ? i : 0) * out.rs;
#pragma unroll
  for (int j = 0; j < DF; ++j) {
    wmma::store_matrix_sync(stage, o[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int col = 16 * j + c8;
    const float* src = stage + r * 16 + c8;
    if (i < sq && col + 4 <= dv)
      *reinterpret_cast<float4*>(orow + col) = make_float4(src[0], src[1], src[2], src[3]);
    if (i < sq && col + 8 <= dv)
      *reinterpret_cast<float4*>(orow + col + 4) = make_float4(src[4], src[5], src[6], src[7]);
    __syncwarp();
  }
}

template <int DF>
cudaError_t launch_flat(const FlatIn& q, const FlatIn& k, const FlatIn& v, const FlatBias& bias,
                        const FlatOut& out, int batch, int heads, int sq, int sk, int dk, int dv,
                        float scale, cudaStream_t stream) {
  const long long smem = flat_smem_bytes(DF);
  cudaError_t err = cudaFuncSetAttribute(flat_attention_kernel<DF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kAttnQTile - 1) / kAttnQTile, heads, batch);
  flat_attention_kernel<DF><<<grid, kAttnThreads, smem, stream>>>(q, k, v, bias, out, sq, sk,
                                                                   dk, dv, scale);
  return cudaGetLastError();
}

// -- block A: a few query rows per (sample, head) -------------------------------------
constexpr int kSqThreads = 256;
constexpr int kSqWarps = kSqThreads / 32;
constexpr int kSqGroup = 8;                        // lanes reading one key row
constexpr int kSqGroups = kSqThreads / kSqGroup;   // key rows per sweep of the block
constexpr int kSqUnroll = 4;                       // key rows in flight per lane group
constexpr int kSqMaxDim = 128;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float4 round_bf16(float4 x) {
  return make_float4(round_bf16(x.x), round_bf16(x.y), round_bf16(x.z), round_bf16(x.w));
}
__device__ __forceinline__ float4 load4(const float* p, bool valid) {
  return valid ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// block-wide max or sum of one value per thread; `red` holds kSqWarps floats
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kSqWarps; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

long long single_query_smem_bytes(int sk) {
  return (((long long)sk + 3) / 4 * 4 + kSqWarps * kSqMaxDim + 2 * kSqWarps) * 4;
}

// N float4 of a row per lane of a group: columns (u * 8 + lane_in_group) * 4
template <int N>
__global__ void __launch_bounds__(kSqThreads)
    single_query_kernel(FlatIn q, FlatIn k, FlatIn v, FlatBias bias, FlatOut out, int sq,
                        int sk, int dk, int dv, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* w = sm;                                    // logits, then weights, of one row
  float* part = sm + ((sk + 3) / 4) * 4;            // per-warp partial outputs
  float* red = part + kSqWarps * kSqMaxDim;         // max and sum scratch
  const int b = blockIdx.y, h = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = tid / kSqGroup, j = tid % kSqGroup;
  const float* kb = k.p + b * k.bs + h * k.hs;
  const float* vb = v.p + b * v.bs + h * v.hs;
  const float* bb = bias.p == nullptr ? nullptr : bias.p + b * bias.bs + h * bias.hs;

#pragma unroll 1
  for (int i = 0; i < sq; ++i) {
    // this lane's columns of the query row, rounded to bf16
    const float* qrow = q.p + b * q.bs + h * q.hs + (long long)i * q.rs;
    float4 qr[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int c = (u * kSqGroup + j) * 4;
      qr[u] = round_bf16(load4(qrow + c, c < dk));
    }
    // pass 1: every key row read once, scale * (bf16 q . bf16 k) into w
#pragma unroll 1
    for (int base = 0; base < sk; base += kSqGroups * kSqUnroll) {  // uniform: shuffles below
      const int key0 = base + group;
      float4 kr[kSqUnroll][N];
#pragma unroll
      for (int t = 0; t < kSqUnroll; ++t) {
        const int key = key0 + t * kSqGroups;
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const int c = (u * kSqGroup + j) * 4;
          kr[t][u] = load4(kb + (long long)(key < sk ? key : 0) * k.rs + c, key < sk && c < dk);
        }
      }
#pragma unroll
      for (int t = 0; t < kSqUnroll; ++t) {
        float dot = 0.0f;
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const float4 x = round_bf16(kr[t][u]);
          dot = fmaf(qr[u].x, x.x, dot);
          dot = fmaf(qr[u].y, x.y, dot);
          dot = fmaf(qr[u].z, x.z, dot);
          dot = fmaf(qr[u].w, x.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const int key = key0 + t * kSqGroups;
        if (j == 0 && key < sk) w[key] = dot * scale;
      }
    }
    __syncthreads();
    // the row's f32 softmax over all its keys, then the weights rounded to bf16
    const float* brow = bb == nullptr ? nullptr : bb + (long long)i * bias.qs;
    float m = -INFINITY;
    for (int c = tid; c < sk; c += kSqThreads) {
      const float logit = brow == nullptr ? w[c] : w[c] + brow[(long long)c * bias.ks];
      w[c] = logit;
      m = fmaxf(m, logit);
    }
    m = block_reduce<true>(m, red);
    float s = 0.0f;
    for (int c = tid; c < sk; c += kSqThreads) {
      // subtract first: near -1e5 (a masked row) a logit scaled by log2 e would
      // lose the bits that tell its keys apart
      const float e = exp2f((w[c] - m) * kLog2e);
      w[c] = e;
      s += e;
    }
    const float inv = 1.0f / block_reduce<false>(s, red + kSqWarps);
    for (int c = tid; c < sk; c += kSqThreads) w[c] = round_bf16(w[c] * inv);
    __syncthreads();
    // pass 2: every value row read once, w . bf16(v) per lane, then per warp
    float4 acc[N];
#pragma unroll
    for (int u = 0; u < N; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int base = 0; base < sk; base += kSqGroups * kSqUnroll) {  // uniform: shuffles below
      const int key0 = base + group;
      float4 vr[kSqUnroll][N];
#pragma unroll
      for (int t = 0; t < kSqUnroll; ++t) {
        const int key = key0 + t * kSqGroups;
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const int c = (u * kSqGroup + j) * 4;
          vr[t][u] = load4(vb + (long long)(key < sk ? key : 0) * v.rs + c, key < sk && c < dv);
        }
      }
#pragma unroll
      for (int t = 0; t < kSqUnroll; ++t) {
        const int key = key0 + t * kSqGroups;
        const float p = key < sk ? w[key] : 0.0f;
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const float4 x = round_bf16(vr[t][u]);
          acc[u].x = fmaf(p, x.x, acc[u].x);
          acc[u].y = fmaf(p, x.y, acc[u].y);
          acc[u].z = fmaf(p, x.z, acc[u].z);
          acc[u].w = fmaf(p, x.w, acc[u].w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
#pragma unroll
      for (int o = 8; o < 32; o <<= 1) {
        acc[u].x += __shfl_xor_sync(0xffffffffu, acc[u].x, o);
        acc[u].y += __shfl_xor_sync(0xffffffffu, acc[u].y, o);
        acc[u].z += __shfl_xor_sync(0xffffffffu, acc[u].z, o);
        acc[u].w += __shfl_xor_sync(0xffffffffu, acc[u].w, o);
      }
      const int c = (u * kSqGroup + lane) * 4;
      if (lane < kSqGroup && c < dv)
        *reinterpret_cast<float4*>(part + warp * kSqMaxDim + c) = acc[u];
    }
    __syncthreads();
    float* orow = out.p + b * out.bs + h * out.hs + (long long)i * out.rs;
    for (int c = tid; c < dv; c += kSqThreads) {
      float total = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kSqWarps; ++wp) total += part[wp * kSqMaxDim + c];
      orow[c] = total;
    }
    __syncthreads();  // w, part and red are rewritten by the next row
  }
}

template <int N>
cudaError_t launch_single_query(const FlatIn& q, const FlatIn& k, const FlatIn& v,
                                const FlatBias& bias, const FlatOut& out, int batch, int heads,
                                int sq, int sk, int dk, int dv, float scale,
                                cudaStream_t stream) {
  // the attribute is a ceiling, set once per instance; each launch asks for its own size
  static const cudaError_t attribute = cudaFuncSetAttribute(
      single_query_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attribute != cudaSuccess) return attribute;
  const long long smem = single_query_smem_bytes(sk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  single_query_kernel<N><<<dim3(heads, batch), kSqThreads, smem, stream>>>(q, k, v, bias, out,
                                                                          sq, sk, dk, dv, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace ovq

extern "C" int ovq_flat_attention_forward(
    const float* q, long long q_bs, long long q_hs, int q_rs, const float* k, long long k_bs,
    long long k_hs, int k_rs, const float* v, long long v_bs, long long v_hs, int v_rs,
    const float* bias, long long bias_bs, long long bias_hs, int bias_qs, int bias_ks,
    float* out, long long out_bs, long long out_hs, int out_rs, int batch, int heads, int sq,
    int sk, int dk, int dv, float scale, cudaStream_t stream) {
  using namespace ovq;
  if (batch <= 0 || heads <= 0 || sq <= 0) return cudaSuccess;
  if (sk <= 0 || dk <= 0 || dv <= 0 || dk % 4 || dv % 4 || dk > 128 || dv > 128)
    return cudaErrorInvalidValue;
  const long long strides = q_bs | q_hs | q_rs | k_bs | k_hs | k_rs | v_bs | v_hs | v_rs | out_bs |
                            out_hs | out_rs;
  if (strides % 4 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  const FlatIn qi{q, q_bs, q_hs, q_rs}, ki{k, k_bs, k_hs, k_rs}, vi{v, v_bs, v_hs, v_rs};
  const FlatBias bi = bias == nullptr ? FlatBias{nullptr, 0, 0, 0, 0}
                                      : FlatBias{bias, bias_bs, bias_hs, bias_qs, bias_ks};
  const FlatOut oi{out, out_bs, out_hs, out_rs};
  const int df = ((dk > dv ? dk : dv) + 15) / 16;
  switch (df) {
#define OVQ_FLAT_CASE(n) \
  case n:                \
    return launch_flat<n>(qi, ki, vi, bi, oi, batch, heads, sq, sk, dk, dv, scale, stream);
    OVQ_FLAT_CASE(1)
    OVQ_FLAT_CASE(2)
    OVQ_FLAT_CASE(3)
    OVQ_FLAT_CASE(4)
    OVQ_FLAT_CASE(5)
    OVQ_FLAT_CASE(6)
    OVQ_FLAT_CASE(7)
    OVQ_FLAT_CASE(8)
#undef OVQ_FLAT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ovq_single_query_attention_forward(
    const float* q, long long q_bs, long long q_hs, int q_rs, const float* k, long long k_bs,
    long long k_hs, int k_rs, const float* v, long long v_bs, long long v_hs, int v_rs,
    const float* bias, long long bias_bs, long long bias_hs, int bias_qs, int bias_ks,
    float* out, long long out_bs, long long out_hs, int out_rs, int batch, int heads, int sq,
    int sk, int dk, int dv, float scale, cudaStream_t stream) {
  using namespace ovq;
  if (batch <= 0 || heads <= 0 || sq <= 0) return cudaSuccess;
  if (sk <= 0 || dk <= 0 || dv <= 0 || dk % 4 || dv % 4 || dk > kSqMaxDim || dv > kSqMaxDim ||
      heads > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  const long long strides = q_bs | q_hs | q_rs | k_bs | k_hs | k_rs | v_bs | v_hs | v_rs;
  if (strides % 4 || !aligned16(q) || !aligned16(k) || !aligned16(v))
    return cudaErrorInvalidValue;
  const FlatIn qi{q, q_bs, q_hs, q_rs}, ki{k, k_bs, k_hs, k_rs}, vi{v, v_bs, v_hs, v_rs};
  const FlatBias bi{bias, bias_bs, bias_hs, bias_qs, bias_ks};
  const FlatOut oi{out, out_bs, out_hs, out_rs};
  switch (((dk > dv ? dk : dv) + 31) / 32) {
#define OVQ_SINGLE_CASE(n) \
  case n:                  \
    return launch_single_query<n>(qi, ki, vi, bi, oi, batch, heads, sq, sk, dk, dv, scale, stream);
    OVQ_SINGLE_CASE(1)
    OVQ_SINGLE_CASE(2)
    OVQ_SINGLE_CASE(3)
    OVQ_SINGLE_CASE(4)
#undef OVQ_SINGLE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
