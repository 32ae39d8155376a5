// Flash attention backward for Hopper (sm_90a), float32 and bfloat16 inputs.
//
// Replaces mxnet_tpu/kernels/flash.py:_flash_backward, the blocked
// recompute that the JAX package runs as plain JAX on the TPU (FlashAttention
// eq. 13-16). Given q, k, v, the forward's output o, its per-row
// log-sum-exp lse and the output gradient dO, with P = exp(scale * q k^T -
// lse) (masked), dP = dO v^T, D = rowsum(dO o) and dS = P (dP - D):
//
//   dq = scale * dS k,    dk = scale * dS^T q,    dv = P^T dO.
//
// Two deterministic kernels, no atomics; the (S, S) matrices never reach
// device memory:
//
// * flash_bwd_dq_kernel: one block per (batch*head, q tile). It computes
//   D for its rows (and writes it for the second kernel), then streams k/v
//   tiles, recomputing P and dP in registers and accumulating dq.
// * flash_bwd_dkv_kernel: one block per (batch*head, k tile). It keeps its
//   k/v tile in shared memory, streams q/dO tiles with their lse and D,
//   recomputes P^T and dP^T and accumulates dk and dv in registers.
//
// The dq kernel must run first (it writes D). Both keep the forward's
// domain and layout: (bh, S, D) row-major, any S >= 1 (ragged tiles are
// zero-filled and masked), Sq != Sk, causal aligned top-left (q_pos >=
// k_pos; tiles wholly masked are skipped), D a multiple of 8 up to 512 with
// tiles per head-dim bucket, float32 accumulation, outputs in the input
// dtype. All products are float32 FMAs on the CUDA cores (no TF32), so at
// the training shape the float32 rate bounds both kernels.
//
// The launch functions are plain C: each returns cudaGetLastError() after
// its launch and never synchronises.

#include "flash_common.cuh"

namespace {

using namespace mxtt_flash;

template <int BQ, int BK, int DMAX>
struct DqTiles {
  static constexpr int LD = DMAX + 4;
  static constexpr int LDS = BK + 1;
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)BQ * LD + 2 * (size_t)BK * LD + (size_t)BQ * LDS);
};

template <typename T, int BQ, int BK, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ dsum, int sq,
                    int sk, int d, float scale, int causal) {
  constexpr int RQ = BQ / kTY;
  constexpr int CK = BK / kTX;
  constexpr int CD = DMAX / kTX;
  constexpr int LD = DqTiles<BQ, BK, DMAX>::LD;
  constexpr int LDS = DqTiles<BQ, BK, DMAX>::LDS;
  static_assert(RQ >= 1 && CK >= 1 && BQ % kTY == 0 && BK % kTX == 0, "tile shape");

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int head = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - head * n_qt) * BQ;
  const int ty = threadIdx.x / kTX;
  const int tx = threadIdx.x % kTX;
  const int row0 = ty * RQ;
  const int cd = d / kTX;
  const T* kh = k + (size_t)head * sk * d;
  const T* vh = v + (size_t)head * sk * d;
  const T* oh = o + (size_t)head * sq * d;

  load_tile<T, BQ>(Qs, LD, q + (size_t)head * sq * d, q0, sq, d);
  load_tile<T, BQ>(dOs, LD, dout + (size_t)head * sq * d, q0, sq, d);
  __syncthreads();

  // D = rowsum(dO o) and the saved lse of this thread's rows
  float Drow[RQ], L[RQ], acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int q_pos = q0 + row0 + r;
    float part = 0.f;
    if (q_pos < sq)
      for (int c = tx; c < d; c += kTX)
        part = fmaf(dOs[(row0 + r) * LD + c], load1(oh + (size_t)q_pos * d + c), part);
    Drow[r] = group_sum(part);
    L[r] = q_pos < sq ? lse[(size_t)head * sq + q_pos] : 0.f;
    if (tx == 0 && q_pos < sq) dsum[(size_t)head * sq + q_pos] = Drow[r];
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[r][j] = 0.f;
  }

  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/dSs
    load_tile<T, BK>(Ks, LD, kh, k0, sk, d);
    load_tile<T, BK>(Vs, LD, vh, k0, sk, d);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = dp[r][c] = 0.f;
    tile_dots<RQ, CK, LD>(s, Qs, Ks, row0, tx, d);
    tile_dots<RQ, CK, LD>(dp, dOs, Vs, row0, tx, d);

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int q_pos = q0 + row0 + r;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int k_pos = k0 + tx + kTX * c;
        const bool ok = q_pos < sq && k_pos < sk && (!causal || q_pos >= k_pos);
        const float p = ok ? expf(s[r][c] * scale - L[r]) : 0.f;
        dSs[(row0 + r) * LDS + tx + kTX * c] = p * (dp[r][c] - Drow[r]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float ds[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) ds[r] = dSs[(row0 + r) * LDS + kk];
      const float* krow = Ks + kk * LD + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        if (j < cd) {
          const float kv = krow[kTX * j];
#pragma unroll
          for (int r = 0; r < RQ; ++r) acc[r][j] = fmaf(ds[r], kv, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int q_pos = q0 + row0 + r;
    if (q_pos < sq) {
      T* row = dq + ((size_t)head * sq + q_pos) * d + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j)
        if (j < cd) store1(row + kTX * j, acc[r][j] * scale);
    }
  }
}

template <int BK, int BQ, int DMAX>
struct DkvTiles {
  static constexpr int LD = DMAX + 4;
  static constexpr int LDT = BQ + 1;
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)BK * LD + 2 * (size_t)BQ * LD +
                       2 * (size_t)BK * LDT + 2 * (size_t)BQ);
};

template <typename T, int BK, int BQ, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int d, float scale,
                     int causal) {
  constexpr int RK = BK / kTY;    // k rows per thread
  constexpr int CQ = BQ / kTX;    // q columns per thread
  constexpr int CD = DMAX / kTX;
  constexpr int LD = DkvTiles<BK, BQ, DMAX>::LD;
  constexpr int LDT = DkvTiles<BK, BQ, DMAX>::LDT;
  static_assert(RK >= 1 && CQ >= 1 && BK % kTY == 0 && BQ % kTX == 0, "tile shape");

  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Pt = dOs + BQ * LD;
  float* dSt = Pt + BK * LDT;
  float* Ls = dSt + BK * LDT;
  float* Ds = Ls + BQ;

  const int n_kt = (sk + BK - 1) / BK;
  const int head = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - head * n_kt) * BK;
  const int ty = threadIdx.x / kTX;
  const int tx = threadIdx.x % kTX;
  const int row0 = ty * RK;
  const int cd = d / kTX;
  const T* qh = q + (size_t)head * sq * d;
  const T* doh = dout + (size_t)head * sq * d;
  const float* lh = lse + (size_t)head * sq;
  const float* dh = dsum + (size_t)head * sq;

  load_tile<T, BK>(Ks, LD, k + (size_t)head * sk * d, k0, sk, d);
  load_tile<T, BK>(Vs, LD, v + (size_t)head * sk * d, k0, sk, d);

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int j = 0; j < CD; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  const int n_qt = (sq + BQ - 1) / BQ;
  // causal: q tiles wholly before this k tile see none of its keys
  const int qt_first = causal ? k0 / BQ : 0;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BQ>(Qs, LD, qh, q0, sq, d);
    load_tile<T, BQ>(dOs, LD, doh, q0, sq, d);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < sq;
      Ls[i] = in ? lh[q0 + i] : 0.f;
      Ds[i] = in ? dh[q0 + i] : 0.f;
    }
    __syncthreads();

    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int r = 0; r < RK; ++r)
#pragma unroll
      for (int c = 0; c < CQ; ++c) s[r][c] = dp[r][c] = 0.f;
    tile_dots<RK, CQ, LD>(s, Ks, Qs, row0, tx, d);    // k . q
    tile_dots<RK, CQ, LD>(dp, Vs, dOs, row0, tx, d);  // v . dO

#pragma unroll
    for (int r = 0; r < RK; ++r) {
      const int k_pos = k0 + row0 + r;
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int qi = tx + kTX * c;
        const int q_pos = q0 + qi;
        const bool ok = q_pos < sq && k_pos < sk && (!causal || q_pos >= k_pos);
        const float p = ok ? expf(s[r][c] * scale - Ls[qi]) : 0.f;
        Pt[(row0 + r) * LDT + qi] = p;
        dSt[(row0 + r) * LDT + qi] = p * (dp[r][c] - Ds[qi]);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < BQ; ++qq) {
      float p[RK], ds[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        p[r] = Pt[(row0 + r) * LDT + qq];
        ds[r] = dSt[(row0 + r) * LDT + qq];
      }
      const float* dorow = dOs + qq * LD + tx;
      const float* qrow = Qs + qq * LD + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        if (j < cd) {
          const float dov = dorow[kTX * j];
          const float qv = qrow[kTX * j];
#pragma unroll
          for (int r = 0; r < RK; ++r) {
            dv_acc[r][j] = fmaf(p[r], dov, dv_acc[r][j]);
            dk_acc[r][j] = fmaf(ds[r], qv, dk_acc[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int k_pos = k0 + row0 + r;
    if (k_pos < sk) {
      const size_t off = ((size_t)head * sk + k_pos) * d + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        if (j < cd) {
          store1(dk + off + kTX * j, dk_acc[r][j] * scale);
          store1(dv + off + kTX * j, dv_acc[r][j]);
        }
      }
    }
  }
}

// Allows the kernel its dynamic shared memory and checks the grid size.
template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem, long long blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <typename T, int BQ, int BK, int DMAX>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, float* dsum, int bh, int sq, int sk, int d,
                      float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, BQ, BK, DMAX>;
  const size_t smem = DqTiles<BQ, BK, DMAX>::bytes;
  const long long blocks = (long long)((sq + BQ - 1) / BQ) * bh;
  cudaError_t err = prepare(kern, smem, blocks);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), dsum, sq, sk, d,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int BK, int BQ, int DMAX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, BK, BQ, DMAX>;
  const size_t smem = DkvTiles<BK, BQ, DMAX>::bytes;
  const long long blocks = (long long)((sk + BK - 1) / BK) * bh;
  cudaError_t err = prepare(kern, smem, blocks);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

// Tiles per head-dim bucket: the per-thread accumulators stay at 32-128
// floats and shared memory under the 227 KB a block may use.
template <typename T>
cudaError_t dq_for_dim(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, float* dsum, int bh, int sq, int sk, int d,
                       float scale, int causal, cudaStream_t s) {
  if (d <= 64) return launch_dq<T, 64, 64, 64>(q, k, v, o, dout, lse, dq, dsum, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch_dq<T, 64, 32, 128>(q, k, v, o, dout, lse, dq, dsum, bh, sq, sk, d, scale, causal, s);
  if (d <= 256) return launch_dq<T, 32, 32, 256>(q, k, v, o, dout, lse, dq, dsum, bh, sq, sk, d, scale, causal, s);
  return launch_dq<T, 16, 16, 512>(q, k, v, o, dout, lse, dq, dsum, bh, sq, sk, d, scale, causal, s);
}

template <typename T>
cudaError_t dkv_for_dim(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* dsum,
                        void* dk, void* dv, int bh, int sq, int sk, int d,
                        float scale, int causal, cudaStream_t s) {
  if (d <= 64) return launch_dkv<T, 64, 64, 64>(q, k, v, dout, lse, dsum, dk, dv, bh, sq, sk, d, scale, causal, s);
  if (d <= 128) return launch_dkv<T, 32, 64, 128>(q, k, v, dout, lse, dsum, dk, dv, bh, sq, sk, d, scale, causal, s);
  if (d <= 256) return launch_dkv<T, 32, 32, 256>(q, k, v, dout, lse, dsum, dk, dv, bh, sq, sk, d, scale, causal, s);
  return launch_dkv<T, 16, 16, 512>(q, k, v, dout, lse, dsum, dk, dv, bh, sq, sk, d, scale, causal, s);
}

bool bad_shape(int bh, int sq, int sk, int d) {
  return bh < 1 || sq < 1 || sk < 1 || d < 8 || d > 512 || d % 8 != 0;
}

}  // namespace

// q, o, dout, dq (bh, sq, d); k, v (bh, sk, d); all contiguous and 16-byte
// aligned on the current device; lse and dsum (bh, sq) float32. Writes dq
// and dsum = rowsum(dout * o). dtype: 0 float32, 1 bfloat16.
extern "C" int mxtt_flash_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const float* lse,
                                           void* dq, float* dsum, int bh,
                                           int sq, int sk, int d, float scale,
                                           int causal, int dtype,
                                           void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dq_for_dim<float>(q, k, v, o, dout, lse, dq, dsum, bh, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return (int)dq_for_dim<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dsum, bh, sq, sk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// Same layout; reads the dsum that mxtt_flash_attention_bwd_dq wrote
// (launch it first, on the same stream) and writes dk and dv (bh, sk, d).
extern "C" int mxtt_flash_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* dsum, void* dk,
                                            void* dv, int bh, int sq, int sk,
                                            int d, float scale, int causal,
                                            int dtype, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dkv_for_dim<float>(q, k, v, dout, lse, dsum, dk, dv, bh, sq, sk, d, scale, causal, s);
  if (dtype == 1)
    return (int)dkv_for_dim<__nv_bfloat16>(q, k, v, dout, lse, dsum, dk, dv, bh, sq, sk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
