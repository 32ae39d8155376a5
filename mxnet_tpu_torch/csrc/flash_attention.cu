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
// Optionally (training) the kernel also writes each row's log-sum-exp of
// the scaled scores, m + log(max(l, 1e-30)), which the backward kernels
// (flash_attention_bwd.cu) use to recompute probabilities.
//
// The launch function is plain C: it returns cudaGetLastError() after the
// launch and never synchronises.

#include "flash_common.cuh"

namespace {

using namespace mxtt_flash;

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
                 float* __restrict__ lse, int sq, int sk, int d, float scale,
                 int causal) {
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

    tile_dots<RQ, CK, LD>(s, Qs, Ks, row0, tx, d);

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
      // log-sum-exp of the row's scaled scores, for the backward pass
      if (lse != nullptr && tx == 0)
        lse[(size_t)head * sq + q_pos] =
            (m[r] == -INFINITY ? 0.f : m[r]) + logf(denom);
    }
  }
}

template <typename T, int BQ, int BK, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, BQ, BK, DMAX>;
  const size_t smem = Tiles<BQ, BK, DMAX>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((sq + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v,
                           void* o, float* lse, int bh, int sq, int sk, int d,
                           float scale, int causal, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64, 64, 64>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
  if (d <= 128) return launch<T, 64, 32, 128>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
  if (d <= 256) return launch<T, 32, 32, 256>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
  return launch<T, 16, 16, 512>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, stream);
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d), all contiguous and
// 16-byte aligned on the current device. dtype: 0 float32, 1 bfloat16.
// lse (bh, sq) float32 receives each row's log-sum-exp of the scaled,
// masked scores; a null lse writes none (the serving path).
extern "C" int mxtt_flash_attention_forward(const void* q, const void* k,
                                            const void* v, void* o,
                                            float* lse, int bh, int sq,
                                            int sk, int d, float scale,
                                            int causal, int dtype,
                                            void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 8 || d > 512 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_for_dim<float>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return (int)launch_for_dim<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
