// Flash attention forward for Hopper (sm_90a), float32 and bfloat16 inputs.
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash.py:_flash_kernel. One
// block of 128 threads owns one (batch*head, q tile): it loads the q tile
// into shared memory once, then streams k and v tiles through shared
// memory, keeping the online-softmax state (running max m, normaliser l)
// and the output accumulator in registers. The (S, S) score matrix never
// reaches device memory. All arithmetic is float32 (CUDA cores, FMA), so
// the kernel is bound by the float32 rate, not by bytes; products are
// register-blocked (RQ q rows x CK score columns and RQ x CD output
// columns per thread) so each shared-memory read feeds several FMAs.
//
// Threads form 16 row groups of 8 (kTX) lanes; a row group's 8 lanes
// share RQ q rows and split the columns, so row max and row sum reduce
// with three xor shuffles inside the group. Tile sizes depend on the head
// dim: the accumulator is RQ x D/8 floats per thread.
//
// Masking: key columns past Sk (the ragged last tile) and, when causal,
// columns with k_pos > q_pos (top-left aligned, as tril on (Sq, Sk)) get
// a score of -inf. Causal k tiles wholly above the diagonal are skipped.
// Query rows past Sq are computed on zero-filled inputs and never stored.
//
// The launch function is plain C: it returns cudaGetLastError() after the
// launch and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy rows [row0, row0 + ROWS) of a row-major (n_rows, d) matrix into a
// float tile with leading dimension ld; rows past n_rows are zero.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int n_rows, int d) {
  const int chunks = d >> 2;
  for (int i = threadIdx.x; i < ROWS * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) << 2;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) load4(src + (size_t)(row0 + r) * d + c, v);
    *reinterpret_cast<float4*>(dst + r * ld + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
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

template <int BQ, int BK, int DMAX>
struct Tiles {
  static constexpr int LD = DMAX + 4;   // q/k/v rows: float4-aligned, 4 banks apart
  static constexpr int LDP = BK + 1;    // probability rows
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)BQ * LD + 2 * (size_t)BK * LD + (size_t)BQ * LDP);
};

template <typename T, int BQ, int BK, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int sq, int sk, int d, float scale, int causal) {
  constexpr int RQ = BQ / kTY;    // q rows per thread
  constexpr int CK = BK / kTX;    // score columns per thread
  constexpr int CD = DMAX / kTX;  // output columns per thread (at most)
  constexpr int LD = Tiles<BQ, BK, DMAX>::LD;
  constexpr int LDP = Tiles<BQ, BK, DMAX>::LDP;
  static_assert(RQ >= 1 && CK >= 1 && BQ % kTY == 0 && BK % kTX == 0, "tile shape");

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int head = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - head * n_qt) * BQ;
  const int ty = threadIdx.x / kTX;
  const int tx = threadIdx.x % kTX;
  const int row0 = ty * RQ;       // first tile row of this thread
  const int cd = d / kTX;         // output columns this thread owns
  const T* qh = q + (size_t)head * sq * d;
  const T* kh = k + (size_t)head * sk * d;
  const T* vh = v + (size_t)head * sk * d;
  T* oh = o + (size_t)head * sq * d;

  load_tile<T, BQ>(Qs, LD, qh, q0, sq, d);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[r][j] = 0.f;
  }

  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    load_tile<T, BK>(Ks, LD, kh, k0, sk, d);
    load_tile<T, BK>(Vs, LD, vh, k0, sk, d);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.f;

    for (int e = 0; e < d; e += 4) {
      float4 qv[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (row0 + r) * LD + e);
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (tx + kTX * c) * LD + e);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          float t = s[r][c];
          t = fmaf(qv[r].x, kv.x, t);
          t = fmaf(qv[r].y, kv.y, t);
          t = fmaf(qv[r].z, kv.z, t);
          s[r][c] = fmaf(qv[r].w, kv.w, t);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int q_pos = q0 + row0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int k_pos = k0 + tx + kTX * c;
        const bool ok = k_pos < sk && (!causal || q_pos >= k_pos);
        s[r][c] = ok ? s[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      // a row with every score masked so far keeps p = 0, never NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = expf(s[r][c] - m_use);
        sum += p;
        Ps[(row0 + r) * LDP + tx + kTX * c] = p;
      }
      l[r] = l[r] * alpha + group_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) p[r] = Ps[(row0 + r) * LDP + kk];
      const float* vrow = Vs + kk * LD + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        if (j < cd) {
          const float vv = vrow[kTX * j];
#pragma unroll
          for (int r = 0; r < RQ; ++r) acc[r][j] = fmaf(p[r], vv, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int q_pos = q0 + row0 + r;
    if (q_pos < sq) {
      const float denom = fmaxf(l[r], 1e-30f);
      T* orow = oh + (size_t)q_pos * d + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j)
        if (j < cd) store1(orow + kTX * j, acc[r][j] / denom);
    }
  }
}

template <typename T, int BQ, int BK, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, BQ, BK, DMAX>;
  const size_t smem = Tiles<BQ, BK, DMAX>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((sq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v,
                           void* o, int bh, int sq, int sk, int d,
                           float scale, int causal, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64, 64, 64>(q, k, v, o, bh, sq, sk, d, scale, causal, stream);
  if (d <= 128) return launch<T, 64, 32, 128>(q, k, v, o, bh, sq, sk, d, scale, causal, stream);
  if (d <= 256) return launch<T, 32, 32, 256>(q, k, v, o, bh, sq, sk, d, scale, causal, stream);
  return launch<T, 16, 16, 512>(q, k, v, o, bh, sq, sk, d, scale, causal, stream);
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d), all contiguous and
// 16-byte aligned on the current device. dtype: 0 float32, 1 bfloat16.
extern "C" int mxtt_flash_attention_forward(const void* q, const void* k,
                                            const void* v, void* o, int bh,
                                            int sq, int sk, int d,
                                            float scale, int causal,
                                            int dtype, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 8 || d > 512 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_for_dim<float>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return (int)launch_for_dim<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
