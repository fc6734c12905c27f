// Device helpers shared by the attention kernels of flash_attention.cu
// (K1/K2) and sparse_attention.cu (K7a/K7b): conversions to and from fp32,
// reductions over the 8 lanes that share a row, the bf16 tensor-core step
// (mma.sync m16n8k16 with fp32 accumulation) with its fragment helpers, and
// the Hopper operand path: cp.async copies into shared memory, ldmatrix
// fragments from a tile's natural [row][column] layout (plain or
// transposed), ex2.approx, and the hi/lo split of an fp32 operand. Each
// including source is its own library, so the helpers have internal
// linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// Reductions over the 8 threads that share a row (consecutive lanes).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------ bf16 on the tensor cores
// Thread (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, columns 2t
// and 2t + 1 of each 8-column accumulator tile, which is also the
// left-operand layout of the next product.

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------ the Hopper operand path

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or zeros when !full (src is then
// any valid address and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane (g, t) gets row g, columns 2t and
// 2t + 1 of each; trans: rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 2**x (relative error about 2**-22; results below 2**-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) as two bf16 pairs, hi = x truncated to bf16 and lo = RN(x - hi)
// (x - hi is exact in fp32).
__device__ __forceinline__ void split2t(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  hi = __byte_perm(b0, b1, 0x7632);
  lo = bits(__floats2bfloat162_rn(x0 - __uint_as_float(b0 & 0xffff0000u),
                                  x1 - __uint_as_float(b1 & 0xffff0000u)));
}

// The left operand of a 16 x 16 step from accumulator tiles c0 (columns
// 0-7) and c1 (columns 8-15), split hi/lo by split2t.
__device__ __forceinline__ void frag_from_acc_t(const float (&c0)[4],
                                                const float (&c1)[4],
                                                uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  split2t(c0[0], c0[1], hi[0], lo[0]);
  split2t(c0[2], c0[3], hi[1], lo[1]);
  split2t(c1[0], c1[1], hi[2], lo[2]);
  split2t(c1[2], c1[3], hi[3], lo[3]);
}

// The left operand of step kk (16 columns from 16 * kk) for the 16 rows
// from row0 of a bf16 tile of row stride LD.
template <int LD>
__device__ __forceinline__ void lhs_frag(uint32_t (&a)[4], const bf16* s,
                                         int row0, int kk, int lane) {
  ldsm4(a, s + (row0 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 16 * kk +
               8 * (lane / 16));
}

// The same operand read transposed out of a [column][row] tile: A[r][c] =
// s[c][r], rows from row0, columns from 16 * kk.
template <int LD>
__device__ __forceinline__ void lhs_frag_t(uint32_t (&a)[4], const bf16* s,
                                           int row0, int kk, int lane) {
  ldsm4_t(a, s + (16 * kk + lane % 8 + 8 * (lane / 16)) * LD + row0 +
                 8 * ((lane / 8) % 2));
}

// acc[n] += A B for the NT n-tiles (NT even) of a B whose columns are the
// rows of bt (B[k][n] = bt[n][k], row stride LD) over the 16-deep step kk:
// acc = A bt^T.
template <int LD, int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4],
                                       const uint32_t (&a)[4], const bf16* bt,
                                       int kk, int lane) {
  static_assert(NT % 2 == 0, "n-tiles come in pairs");
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    ldsm4(b, bt + (16 * np + lane % 8 + 8 * (lane / 16)) * LD + 16 * kk +
                 8 * ((lane / 8) % 2));
    mma16816(acc[2 * np], a, b[0], b[1]);
    mma16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// acc[n] += (hi + lo) B for the NT n-tiles of B = the rows [16 j, 16 j + 16)
// of a tile of row stride LD (B[k][n] = bs[16 j + k][n]): acc = A bs over
// the 16-deep step j, A as two bf16 terms.
template <int LD, int NT>
__device__ __forceinline__ void mma_nn2(float (&acc)[NT][4],
                                        const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4],
                                        const bf16* bs, int j, int lane) {
  static_assert(NT % 2 == 0, "n-tiles come in pairs");
#pragma unroll
  for (int dp = 0; dp < NT / 2; ++dp) {
    uint32_t b[4];
    ldsm4_t(b, bs + (16 * j + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                   16 * dp + 8 * (lane / 16));
    mma16816(acc[2 * dp], hi, b[0], b[1]);
    mma16816(acc[2 * dp], lo, b[0], b[1]);
    mma16816(acc[2 * dp + 1], hi, b[2], b[3]);
    mma16816(acc[2 * dp + 1], lo, b[2], b[3]);
  }
}

// Every accumulator tile to 0.
template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Add the accumulator rows g and g + 8 (the rows row_a and row_a + 8 of
// `base`, row stride ld floats, each added when `live`) times mul into fp32
// memory as float4 atomics (red.global.add.v4.f32): lanes t and t ^ 1 trade
// halves, so the even lane adds four neighbouring columns of row g and the
// odd lane of row g + 8, from column 8 n + 2 (t & 2).
template <int NT>
__device__ __forceinline__ void atomic_add_rows(float* base,
                                                const float (&acc)[NT][4],
                                                int row_a, int ld, float mul,
                                                bool live_a, bool live_b,
                                                int t) {
  const bool odd = t & 1;
  const int row = row_a + (odd ? 8 : 0);
  const bool live = odd ? live_b : live_a;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float s0 = odd ? acc[n][0] : acc[n][2];
    const float s1 = odd ? acc[n][1] : acc[n][3];
    const float x0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 val =
        odd ? make_float4(x0 * mul, x1 * mul, acc[n][2] * mul,
                          acc[n][3] * mul)
            : make_float4(acc[n][0] * mul, acc[n][1] * mul, x0 * mul,
                          x1 * mul);
    if (live)
      atomicAdd(reinterpret_cast<float4*>(base + (size_t)row * ld + 8 * n +
                                          2 * (t & 2)),
                val);
  }
}

}  // namespace
