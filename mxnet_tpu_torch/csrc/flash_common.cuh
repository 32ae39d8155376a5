// Helpers shared by the flash-attention and decode-attention kernels: 4-wide
// loads that widen float32 or bfloat16 to float, 1-wide loads and stores,
// and, for the SIMT kernels (128 threads as 16 row groups of 8), the 8-lane
// row-group reductions and register-blocked tile dot products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mxtt_flash {

constexpr int kThreads = 128;
constexpr int kTX = 8;                  // lanes per row group
constexpr int kTY = kThreads / kTX;     // row groups per block

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// s[r][c] += A[row0 + r] . B[tx + kTX * c] over d columns, for two float
// tiles with leading dimension LD (A: RQ rows per thread, B: CK columns).
template <int RQ, int CK, int LD>
__device__ __forceinline__ void tile_dots(float (&s)[RQ][CK], const float* A,
                                          const float* B, int row0, int tx,
                                          int d) {
  for (int e = 0; e < d; e += 4) {
    float4 av[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + (row0 + r) * LD + e);
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const float4 bv = *reinterpret_cast<const float4*>(B + (tx + kTX * c) * LD + e);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        float t = s[r][c];
        t = fmaf(av[r].x, bv.x, t);
        t = fmaf(av[r].y, bv.y, t);
        t = fmaf(av[r].z, bv.z, t);
        s[r][c] = fmaf(av[r].w, bv.w, t);
      }
    }
  }
}

}  // namespace mxtt_flash
