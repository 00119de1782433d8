// Warp-level building blocks that Hopper keeps from sm_80: cp.async copies
// from global to shared memory, and f32 products on the tensor cores as
// three TF32 products (3xTF32) through mma.sync m16n8k8.
//
// 3xTF32. A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32
// product has a relative error of about 2^-11 a term: too coarse for the
// port's f32 kernels, which are held to 1e-4 of their plain versions. Each
// f32 operand x is split as hi = rna_tf32(x), lo = rna_tf32(x - hi), and
// a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (small terms first)
// into the f32 accumulator. The dropped lo_a.lo_b and the rounding of lo
// leave about 2^-20 a term.
//
// Fragments of m16n8k8 .row.col tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4),
//               a3 (row g + 8, k t + 4)
//   B (8 x 8):  b0 (k t, col g), b1 (k t + 4, col g)
//   C (16 x 8): c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8, the same)
// The order of k inside a k8 step is free as long as A and B agree, which is
// what lets a kernel pick the k of each loaded float.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_mma {

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy kVec floats (4: one 16-byte chunk; 1: one float) from global to
// shared memory asynchronously; floats at or past `valid` are written as 0.
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (kVec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(4 * valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(4 * valid)
                 : "memory");
}

// Whether the rows of a [B, S, H, D] f32 tensor at p, with batch and
// sequence strides sb and ss (in floats), can be read in 16-byte cp.async
// chunks: the base and both strides 4-float aligned (D % 4 is the
// caller's to check).
inline bool rows_vec4(const void* p, long long sb, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
         ss % 4 == 0;
}

// x = hi + lo + (about 2^-22 |x|), both TF32 rounded to nearest with ties
// away from zero: what cvt.rna.tf32.f32 gives for finite x, in integer
// operations on the f32 bits (add half of the 13 dropped bits, clear them).
// ptxas expands cvt.rna.tf32.f32 into about four instructions with a check
// for Inf and NaN; this takes two for hi and two for lo, whose 13 low bits
// are left set: mma.sync reads a .tf32 operand's top 19 bits only.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// The four A (or two B) operands of one fragment split at once.
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// d += a.b on one m16n8k8 TF32 tile, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

}  // namespace warp_mma
