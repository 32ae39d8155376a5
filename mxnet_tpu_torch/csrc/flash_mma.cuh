// Tensor-core pieces of the flash-attention kernels (forward,
// flash_attention.cu; backward, flash_attention_bwd.cu): the float32-accurate
// 3xTF32 split, the m16n8k8 TF32 mma, cp.async copies, strided tile loads
// into shared memory, the two product shapes every kernel is built from, and
// the launch helper that lifts the shared-memory limit.
//
// 3xTF32: each float32 operand x is cut into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away from zero, the
// rounding of cvt.rna.tf32.f32. The mma reads a 32-bit register as TF32 by
// ignoring its low 13 bits without rounding them, so the explicit rounding
// is what makes hi + lo equal x to about float32 precision. A product is then
// a*b ~ hi_a*hi_b + hi_a*lo_b + lo_a*hi_b, the two small terms added first;
// lo_a*lo_b (about 2^-24 of |a*b|) is dropped. A bfloat16 value is exact in
// TF32, so its lo part is zero and callers skip those products (kLo false).
//
// m16n8k8 fragments (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// The two product shapes:
// * QK-shaped (qk_step): C += X Y^T, A from 16 rows of X, B from 8 rows of Y
//   per n8 block (scores q k^T, dO v^T; in the backward's dkv kernel
//   k q^T and v dO^T).
// * PV-shaped (pv_product): C' += C Y, where C is an n8 block of a
//   QK-shaped accumulator (probabilities, or dS) used as the A operand
//   without a shuffle: relabelling the block's 8 columns (A's column t is
//   C's column 2t, column t + 4 is 2t + 1) makes a = (c0, c2, c1, c3), and B
//   is read from Y rows 2t (b0) and 2t + 1 (b1) to match.

#pragma once

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

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

// 4 bytes, as cp_async16 (src_bytes 0: zero, src not read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// Element strides of a (B, H, S, D) operand; D's stride is 1.
struct Strides {
  long long b, h, s;
};

// Rows [row0, row0 + ROWS) of one head's (S, D) operand, row r at
// src + r * stride, into a float tile with leading dimension LD; rows past
// n and columns [d, DMAX) are zero, so a kernel may multiply over all DMAX
// columns without a branch. float32: cp.async, 16 bytes a thread,
// zero-filled by src-size. bfloat16: 8 values a thread through registers,
// widened.
template <int ROWS, int DMAX, int LD, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0, int n,
                                          int d) {
  constexpr int kChunks = DMAX / 4;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
#pragma unroll
  for (int j = 0; j < (ROWS * kChunks + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (ROWS * kChunks % NT != 0 && i >= ROWS * kChunks) break;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool in = row0 + r < n && c < d;
    cp_async16(base + (uint32_t)(r * LD + c) * 4u,
               in ? src + (row0 + r) * stride + c : src, in ? 16 : 0);
  }
}

template <int ROWS, int DMAX, int LD, int NT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int n,
                                          int d) {
  constexpr int kChunks = DMAX / 8;
#pragma unroll
  for (int j = 0; j < (ROWS * kChunks + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (ROWS * kChunks % NT != 0 && i >= ROWS * kChunks) break;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    float w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n && c < d) {
      const __nv_bfloat16* p = src + (row0 + r) * stride + c;
      load4(p, w);
      load4(p + 4, w + 4);
    }
    float4* q = reinterpret_cast<float4*>(dst + r * LD + c);
    q[0] = make_float4(w[0], w[1], w[2], w[3]);
    q[1] = make_float4(w[4], w[5], w[6], w[7]);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A fragment of tile rows row0 .. row0 + 15, columns 8 kk .. 8 kk + 7, from
// a float tile; split into hi and lo when kLo, else taken as it is.
template <int LD, bool kLo>
__device__ __forceinline__ void a_fragment(const float* Xs, int row0, int kk,
                                           int g, int t, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float* p = Xs + (row0 + g) * LD + kk * 8 + t;
  const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kLo) split_tf32(x[i], hi[i], lo[i]);
    else hi[i] = __float_as_uint(x[i]);
  }
}

// QK-shaped, one k8 step: s[nb] += A Y^T for the n8 blocks nb < NB, where A
// (hi, lo) holds columns 8 kk .. 8 kk + 7 of 16 rows and B = Y^T is read
// from Y rows 8 nb + g, columns 8 kk + t and + 4 (b0 = Y[8 nb + g][8 kk + t]).
// With kLo, Y is split and the two small products go first.
template <int NB, int LD, bool kLo>
__device__ __forceinline__ void qk_step(float (&s)[NB][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const float* Y, int kk, int g,
                                        int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const float* yp = Y + (nb * 8 + g) * LD + kk * 8 + t;
    if (kLo) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(yp[0], bh0, bl0);
      split_tf32(yp[4], bh1, bl1);
      mma_tf32(s[nb], ah, bl0, bl1);   // the small terms first
      mma_tf32(s[nb], al, bh0, bh1);
      mma_tf32(s[nb], ah, bh0, bh1);
    } else {
      mma_tf32(s[nb], ah, __float_as_uint(yp[0]), __float_as_uint(yp[4]));
    }
  }
}

// PV-shaped: acc[nd] += C Y for the n8 blocks nd < KD of Y's columns, where
// C is one n8 block of a float32 accumulator (always split: probabilities
// and dS are computed values) relabelled as the A operand, a = (c0, c2, c1,
// c3), and Y points at the block's first row: b0 = Y[2t][8 nd + g],
// b1 = Y[2t + 1][8 nd + g]. With kLo, Y is split too.
template <int KD, int LD, bool kLo>
__device__ __forceinline__ void pv_product(float (&acc)[KD][4],
                                           const float (&c)[4],
                                           const float* Y, int g, int t) {
  uint32_t ph[4], pl[4];
  split_tf32(c[0], ph[0], pl[0]);
  split_tf32(c[2], ph[1], pl[1]);
  split_tf32(c[1], ph[2], pl[2]);
  split_tf32(c[3], ph[3], pl[3]);
  const float* yp = Y + 2 * t * LD + g;
#pragma unroll
  for (int nd = 0; nd < KD; ++nd) {
    const float y0 = yp[nd * 8];
    const float y1 = yp[nd * 8 + LD];
    if (kLo) {
      uint32_t yh0, yl0, yh1, yl1;
      split_tf32(y0, yh0, yl0);
      split_tf32(y1, yh1, yl1);
      mma_tf32(acc[nd], ph, yl0, yl1);
      mma_tf32(acc[nd], pl, yh0, yh1);
      mma_tf32(acc[nd], ph, yh0, yh1);
    } else {
      mma_tf32(acc[nd], pl, __float_as_uint(y0), __float_as_uint(y1));
      mma_tf32(acc[nd], ph, __float_as_uint(y0), __float_as_uint(y1));
    }
  }
}

// ---------------------------------------------------------------------------
// Launch

constexpr int kMaxDevices = 64;

// Lift the 48 KB default limit on dynamic shared memory, once per device
// for each kernel (Kern).
template <const void* (*Kern)(), size_t kBytes>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(Kern(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kBytes);
  if (e == cudaSuccess) done[dev].store(true);
  return e;
}

}  // namespace mxtt_flash
