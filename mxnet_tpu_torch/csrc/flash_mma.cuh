// Tensor-core helpers of the flash-attention kernels: the float32-accurate
// 3xTF32 split, the m16n8k8 TF32 mma and 16-byte cp.async copies.
//
// 3xTF32: each float32 operand x is cut into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away from zero, the
// rounding of cvt.rna.tf32.f32. The mma reads a 32-bit register as TF32 by
// ignoring its low 13 bits without rounding them, so the explicit rounding
// is what makes hi + lo equal x to about float32 precision. A product is then
// a*b ~ hi_a*hi_b + hi_a*lo_b + lo_a*hi_b, the two small terms added first;
// lo_a*lo_b (about 2^-24 of |a*b|) is dropped. A bfloat16 value is exact in
// TF32, so its lo part is zero and callers skip those products.
//
// m16n8k8 fragments (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtt_flash {

// cvt.rna.tf32.f32's rounding as two integer operations on the float's
// bits: add half of TF32's last place, then clear the 13 bits below it (a
// carry into the exponent rounds up correctly). Equal to cvt.rna for every
// finite x. cvt is a conversion instruction, which the SM issues at a
// quarter of the integer rate, and the kernels split every element they
// multiply; the integer form made the forward kernel faster on the card.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about float32 precision (x - hi is exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory; src_bytes < 16 zero-fills the
// rest (0: all zero, and src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mxtt_flash
