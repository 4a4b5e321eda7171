// Shared pieces of the port's hand-written Hopper kernels (built for sm_90a).
//
// Device helpers are inline here; the GEMM core the kernels are assembled from
// lives in gemm_sm90.cu and is reached through the launchers declared below:
//   * sm90_gemm_bias, sm90_gemm_ln (gemm_sm90.cu): the wgmma + TMA GEMM core of
//     kernels C and F on bf16 rows, with the bias [+ GELU] epilogue to bf16 or the
//     residual + LayerNorm one to f32.
// The mma.sync pieces below (ldmatrix operands, m16n8k16 products, bf16 packing)
// build block B (fused_attention.cu: the packed, dropout, two-bias and kernel F
// attentions) and the dropout backward pair (fused_attention_dropout.cu); the
// wgmma, mbarrier, TMA, setmaxnreg and cluster pieces build gemm_sm90.cu, the
// persistent step kernel (decoder_layer_step.cu: kernels A, B, D, E and the
// decoder-layer step) and the streamed attention (fused_attention_streamed.cu).
// Every launcher returns cudaGetLastError() after its launch.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ovq {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// exact-erf GELU (torch.nn.functional.gelu's default)
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// four consecutive f32 values as four bf16 in a uint2 (zeros when !valid)
__device__ __forceinline__ uint2 load_quad(const float* p, bool valid) {
  const float4 v = valid ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
}

// the flat attention's tile block (fused_attention_flat.cu): 64-row tiles, 64-row
// key chunks, 4 warps of 16 rows
constexpr int kAttnQTile = 64;
constexpr int kAttnKeyChunk = 64;
constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;

constexpr float kMaskValue = -10e4f;  // models/modules/masks.py MASK_VALUE

// one f32 value stored as a cache holds it (the step kernel's slot writes)
__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(bf16* p, float v) { *p = __float2bfloat16(v); }

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

// -- Hopper pieces (sm_90a): wgmma, mbarrier, TMA, setmaxnreg, clusters -----------
// A shared-memory matrix descriptor of a tile stored with the 128-byte swizzle
// (rows of 128 bytes, the XOR pattern repeating every 8 rows = 1024 bytes, as a
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes it; tile bases 1024-aligned):
// start address, leading and stride byte offsets in 16-byte units, layout 1 =
// SWIZZLE_128B in bits 62-63.  K-major A (rows of K): the stride offset is the
// 1024 bytes between 8-row groups, the leading one unused; a k16 step within the
// 128-byte row advances the start by 32 bytes.  MN-major B ((K, N) row-major
// weight, 64-column boxes stacked): the leading offset is the bytes between two
// 64-column boxes, the stride offset the 1024 bytes between 8-row K groups; a k16
// step advances the start by 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile, unsigned lead_bytes,
                                               unsigned stride_bytes) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFFull) >> 4) | (uint64_t)((lead_bytes >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((stride_bytes >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across the asynchronous products;
// before a wgmma_fence, from moving the writes of an operand (accumulators, or A
// fragments in registers) past it, where the product could read them stale; after
// a wgmma_wait, from giving an A fragment's registers to other values while the
// product still reads them (the asm takes them as inputs when the product starts)
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_operands(unsigned (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 operands from shared memory, f32 accumulators,
// B transposed (MN-major).  Thread (warp w of the warpgroup, lane g * 4 + t)
// holds rows 16w + g (d[4j], d[4j + 1]) and 16w + g + 8 (d[4j + 2], d[4j + 3]) of
// columns 8j + 2t and 8j + 2t + 1.
// acc (64 x 64, this thread's 32 floats) += A (64 x 16, K-major) * B (16 x 64, MN-major;
// TRANS_B 0: K-major, rows of K, a K^T operand)
template <int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// acc (64 x 128, this thread's 64 floats) += A (64 x 16, K-major) * B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// acc (64 x 256, this thread's 128 floats) += A (64 x 16, K-major) * B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// the same products with A (64 x 16 bf16) from registers, in mma.sync's A fragment
// layout per warp (warp w of the warpgroup holds rows 16w .. 16w + 15): an
// accumulator tile packed to bf16 is the next product's A (FlashAttention-3's
// accumulator-to-operand identity).  B MN-major (rows of N).
// acc (64 x 64) += A (64 x 16, registers) * B (16 x 64)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// acc (64 x 128) += A (64 x 16, registers) * B (16 x 128)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const unsigned (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// mbarriers in shared memory
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA tile load of a 2-D tensor map (coordinates innermost first) into this
// CTA's shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one TMA tile store from this CTA's shared memory to a 2-D tensor map (the map
// clips what lies outside the matrix), in the thread's current bulk group; the
// shared-memory writes it reads must be fenced to the async proxy first
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk groups have finished reading shared memory (READ) or completed
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier over the first `threads` threads of the CTA (named barrier `id` >= 1)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// register budgets of a producer / consumer warpgroup split (whole warpgroups)
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// thread-block clusters: split arrive / wait barriers over every thread of the
// cluster, and a float read from a peer CTA's shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ float ld_peer(const float* local, unsigned rank) {
  unsigned remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(local)),
               "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// -- the split-K reduce passes, as device functions ---------------------------------
// rows_reduce_ln_kernel and rows_reduce_bias_kernel (gemm_sm90.cu) and the
// decoder-layer step's phases (decoder_layer_step.cu) call these, so that the layer
// step's FFN phase sums and normalises in kernel C's order, bit for bit.
constexpr int kRowThreads = 256;  // the threads of one row's LayerNorm

// the sum of one value per thread over the kRowThreads threads of the block;
// `scratch` holds kRowThreads / 32 floats
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) total += scratch[w];
  __syncthreads();  // scratch is reused by the next call
  return total;
}

// row `row` of Y[M, N] = LayerNorm(bias + R + the `splits` (M, N) slices of
// `partial`, summed in order) * gamma + beta, and the same rounded to bf16 in Yb
// unless it is null; every thread of a kRowThreads block calls it, N <= 1024
__device__ __forceinline__ void reduce_ln_row(const float* partial, int splits,
                                              const float* bias, const float* R,
                                              const float* gamma, const float* beta, float* Y,
                                              bf16* Yb, int M, int N, float eps, size_t row,
                                              float* scratch) {
  float v[4];
  float sum = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = threadIdx.x + u * kRowThreads;
    v[u] = 0.0f;
    if (c < N) {
      float value = bias[c] + R[row * N + c];
#pragma unroll 4
      for (int s = 0; s < splits; ++s) value += partial[((size_t)s * M + row) * N + c];
      v[u] = value;
      sum += value;
    }
  }
  const float mean = block_sum(sum, scratch) / N;
  float sq = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = threadIdx.x + u * kRowThreads;
    if (c < N) sq += (v[u] - mean) * (v[u] - mean);
  }
  const float rstd = rsqrtf(block_sum(sq, scratch) / N + eps);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = threadIdx.x + u * kRowThreads;
    if (c < N) {
      const float y = (v[u] - mean) * rstd * gamma[c] + beta[c];
      Y[row * N + c] = y;
      if (Yb != nullptr) Yb[row * N + c] = __float2bfloat16(y);
    }
  }
}

// elements e .. e + 3 (e a multiple of 4, N of 4) of Y[M, N] (bf16) = epi(bias + the
// `splits` (M, N) slices of `partial`, summed in order), epi the identity or the
// exact-erf GELU
template <bool GELU>
__device__ __forceinline__ void reduce_bias_quad(const float* partial, int splits,
                                                 const float* bias, bf16* Y, long long e,
                                                 long long slice, int N) {
  const int c = (int)(e % N);
  float4 v = *reinterpret_cast<const float4*>(bias + c);
  for (int s = 0; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(partial + s * slice + e);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  if (GELU) {
    v.x = gelu_erf(v.x);
    v.y = gelu_erf(v.y);
    v.z = gelu_erf(v.z);
    v.w = gelu_erf(v.w);
  }
  *reinterpret_cast<uint2*>(Y + e) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// four f32 values at x + 4q rounded to bf16 at y + 4q
__device__ __forceinline__ void cast_quad(const float* x, bf16* y, long long q) {
  const float4 v = reinterpret_cast<const float4*>(x)[q];
  reinterpret_cast<uint2*>(y)[q] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// -- the wgmma + TMA GEMM core of kernels C and F (gemm_sm90.cu) --------------------
// How one product is cut over the card; ops/_cuda.py::gemm_plan chooses it.
//   bm x bn:  the output tile of one CTA (bm 64 or 128 rows: one or two consumer
//             warpgroups; bn 64, 128 or 256 columns);
//   splits:   CTAs along K, each over k_slice of it (a multiple of 64);
//   cluster:  0: each CTA writes its raw f32 partial tile (64 x 64 only) to
//             `partial` (splits * M * N floats) and a second pass sums the slices
//             and runs the epilogue;
//             >= 1: the epilogue runs in the GEMM (splits 1), for the LayerNorm over
//             a cluster of `cluster` CTAs along N (N == cluster * bn) that trade
//             their rows' partial sums through distributed shared memory.
struct GemmPlan {
  int bm, bn, splits, k_slice, cluster;
};

// Y[M, N] (bf16, row stride N) = epi(A[M, K] @ W[K, N] + bias[N]), epi the identity
// or exact-erf GELU; A bf16 rows of stride K, W bf16 (K, N) row-major; N and K
// multiples of 8.
cudaError_t sm90_gemm_bias(const bf16* A, const bf16* W, const float* bias, bf16* Y,
                           float* partial, int M, int N, int K, bool gelu, GemmPlan plan,
                           cudaStream_t stream);

// Y[M, N] (f32) = LayerNorm(R[M, N] + A[M, K] @ W[K, N] + bias[N]) * gamma + beta, R f32
// rows of stride N, N a multiple of 128 up to 1024.
cudaError_t sm90_gemm_ln(const bf16* A, const bf16* W, const float* bias, const float* R,
                         const float* gamma, const float* beta, float* Y, float* partial, int M,
                         int N, int K, float eps, GemmPlan plan, cudaStream_t stream);

// y[n] = bf16(x[n]): the f32 activation as the GEMMs' A operand (TMA copies bytes)
cudaError_t cast_to_bf16(const float* x, bf16* y, long long n, cudaStream_t stream);

// The TMA map of a bf16 (rows, cols) row-major matrix read in boxes of box_rows x
// 64 columns with the 128-byte swizzle, zero-filled outside (cached per pointer,
// shape and box); false when cuTensorMapEncodeTiled refuses it
bool bf16_tensor_map(CUtensorMap* out, const bf16* p, int rows, int cols, int box_rows);

// Block B's bf16 instance (fused_attention.cu): the packed (b, S, 3 * hd) q|k|v
// projection in, the bf16 context (b, S, hd) out, under a (b, S) key bias; K and V
// resident in shared memory or in a two-slot ring
cudaError_t packed_attention_qkv(const bf16* qkv, const float* key_bias, bf16* out, int batch,
                                 int seq, int hd, int heads, float scale, int resident,
                                 cudaStream_t stream);

}  // namespace ovq
