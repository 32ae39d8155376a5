// Flash attention forward for Hopper (sm_90a), float32 and bfloat16 inputs,
// on the tensor cores.
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash.py:108 flash_forward (its
// pallas_call; body _flash_kernel at :38). Contract, as there:
// out = softmax(scale * q k^T, masked) v, accumulated in float32 with an
// online softmax (running max m, normaliser l, final divide by
// max(l, 1e-30)), output in q's dtype; causal aligned top-left
// (q_pos >= k_pos); Sq != Sk allowed; any S >= 1; D a multiple of 8 up to
// 512. Optionally (training) it writes each row's log-sum-exp of the
// scaled, masked scores, m + log(max(l, 1e-30)), which the backward kernels
// (flash_attention_bwd.cu) read to recompute probabilities.
//
// What bounds it: at the serving shape (B*H = 384, S = 128, D = 64,
// float32) a call is 4*B*H*S*S*D = 1.61 GFLOP. As three TF32 products that
// is 4.83 GFLOP, 9.8 us at the tensor cores' 495 TFLOP/s, while the 50.3 MB
// of q, k, v and o take 15.0 us at 3.35 TB/s: bytes bound it. (On the CUDA
// cores' 67 TFLOP/s of float32 the same call needs 24 us.)
//
// What the design does about it:
// * Products on the tensor cores (mma.sync m16n8k8 TF32), made float32
//   accurate by the 3xTF32 split of flash_mma.cuh. For bfloat16 inputs the
//   lo parts of q, k and v are zero, so a compile-time flag (kLo) drops
//   their products: Q K^T takes one product, P V two (P's hi and lo).
//   mma.sync does not reach the wgmma rate that the 495 TFLOP/s assume, so
//   in practice the 192 mma of a warp's k tile and the splits that feed
//   them, not the bytes, take most of the time (PERF.md).
// * Device traffic is one read of q, k, v and one write of o, read and
//   written in place through their (B, H, S) strides with D contiguous, so
//   the (B, S, H, D) activations of a MultiHeadAttention need no copy
//   either way. The (S, S) scores never leave registers.
// * One block of 4 warps owns 64 q rows of one (batch, head); each warp owns
//   16 rows. Its q rows are split once and kept in registers as A
//   fragments (hi and lo) for every k tile (D <= 64; at D <= 128 they would
//   not fit beside the output, so they stay in shared memory and are split
//   where they are read). At D <= 64 a thread holds 166 registers, so 3
//   blocks (12 warps) share an SM.
// * k and v tiles of 32 keys arrive by cp.async (16 bytes a thread) into a
//   ring of two stages, tile kt + 1 in flight while tile kt is computed;
//   rows past Sk are zero-filled by the copy's src-size and their scores
//   masked to -inf. bfloat16 tiles go through registers instead (cp.async
//   cannot widen) and land as float32, so one mma core serves both types.
//   Rows are padded to D + 4 floats, so the fragment reads (g, t) and
//   (2t, g) and the 16-byte copies are free of bank conflicts. Columns
//   from D up to the tile's width are zero-filled too, so the unrolled
//   products run over the whole width without a branch (a branch per k8
//   step kept the compiler from overlapping loads, splits and mma).
// * P stays in registers between the two products. The S accumulator holds
//   a thread's P at keys 2t, 2t + 1 of each n8 block; the A operand of P V
//   wants columns t, t + 4. Relabelling the block's 8 keys (A's column t is
//   key 2t, column t + 4 is key 2t + 1) makes a = (c0, c2, c1, c3), and V's
//   B fragment is read from V rows 2t and 2t + 1 to match.
// * The softmax runs in fragment coordinates, in base 2 (scores times
//   scale * log2(e), exp2): rows q0 + 16 w + g and + 8, keys k0 + 8 nb + 2t
//   and + 1; row max and sum reduce over the 4 lanes of a row (two xor
//   shuffles). Tiles with no masked score skip the mask. Causal k tiles
//   wholly above the diagonal are skipped by the block, and by a warp whose
//   16 rows they all lie above.
//
// D above 128 takes the SIMT kernel below (float32 FMAs on the CUDA cores,
// register-blocked), whose 16 x 512 accumulator would not fit a warp's
// registers as mma fragments. The launcher picks the path by D alone and
// reports it; it is never a fallback.
//
// The launch function is plain C: it returns cudaGetLastError() after the
// launch and never synchronises.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mxtt_flash;

template <typename T>
struct Fwd {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;
  Strides qs, ks, vs, os;
  int heads, sq, sk, d;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// Tensor-core path (D <= 128)

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // q rows per block
constexpr int kBK = 32;            // keys per k tile

template <int DMAX>
struct MmaTiles {
  static constexpr int LD = DMAX + 4;
  static constexpr bool kQRegs = DMAX <= 64;
  static constexpr int kStage = 2 * kBK * LD;   // a k tile, then its v tile
  // with kQRegs the q tile passes through stage 1 before the loop
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)kStage + (kQRegs ? 0 : (size_t)kBQ * LD));
  static constexpr int kMinBlocks = kQRegs ? 3 : 2;
  static_assert(kBQ <= 2 * kBK, "the q tile must fit one stage");
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kMmaThreads, MmaTiles<DMAX>::kMinBlocks)
flash_fwd_mma_kernel(const Fwd<T> a) {
  using Tl = MmaTiles<DMAX>;
  constexpr int LD = Tl::LD;
  constexpr int NB = kBK / 8;      // n8 blocks of scores in a k tile
  constexpr int KD = DMAX / 8;     // k8 steps of Q K^T, n8 blocks of the output
  constexpr bool kLo = std::is_same<T, float>::value;

  extern __shared__ float4 smem_f4[];
  float* const stages = reinterpret_cast<float*>(smem_f4);
  float* const Qs = stages + (Tl::kQRegs ? Tl::kStage : 2 * Tl::kStage);

  const int n_qt = (a.sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kBQ;
  const int bi = bh / a.heads;
  const int head = bh - bi * a.heads;
  const T* qh = a.q + bi * a.qs.b + head * a.qs.h;
  const T* kh = a.k + bi * a.ks.b + head * a.ks.h;
  const T* vh = a.v + bi * a.vs.b + head * a.vs.h;
  T* oh = a.o + bi * a.os.b + head * a.os.h;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;   // the warp's first tile row

  int n_kt = (a.sk + kBK - 1) / kBK;
  if (a.causal) n_kt = min(n_kt, (q0 + kBQ + kBK - 1) / kBK);

  auto load_kv = [&](int kt) {
    float* ks = stages + (kt & 1) * Tl::kStage;
    load_rows<kBK, DMAX, LD, kMmaThreads>(ks, kh, a.ks.s, kt * kBK, a.sk, a.d);
    load_rows<kBK, DMAX, LD, kMmaThreads>(ks + kBK * LD, vh, a.vs.s, kt * kBK,
                                          a.sk, a.d);
  };

  load_rows<kBQ, DMAX, LD, kMmaThreads>(Qs, qh, a.qs.s, q0, a.sq, a.d);
  cp_async_commit();
  load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();   // the q tile
  __syncthreads();

  uint32_t qhi[Tl::kQRegs ? KD : 1][4], qlo[Tl::kQRegs ? KD : 1][4];
  if constexpr (Tl::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      a_fragment<LD, kLo>(Qs, wr, kk, g, t, qhi[kk], qlo[kk]);
    __syncthreads();   // stage 1 is free for k tile 1
  }

  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running row max, base 2
  float l[2] = {0.f, 0.f};   // this thread's part of the row sums
  const float scale2 = a.scale * 1.4426950408889634f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();   // k tile kt has landed
    __syncthreads();
    const int k0 = kt * kBK;
    const float* Ks = stages + (kt & 1) * Tl::kStage;
    const float* Vs = Ks + kBK * LD;
    // causal: every score of this tile lies above all 16 rows of the warp
    if (!a.causal || k0 <= q0 + wr + 15) {
      float s[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;

#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (Tl::kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qhi[kk][i];
            if (kLo) al[i] = qlo[kk][i];
          }
        } else {
          a_fragment<LD, kLo>(Qs, wr, kk, g, t, ah, al);
        }
        // B = K^T: b0 = K[key 8 nb + g][8 kk + t], b1 at column + 4
        qk_step<NB, LD, kLo>(s, ah, al, Ks, kk, g, t);
      }

      // online softmax on rows g (h2 = 0) and g + 8 (h2 = 1), in base 2:
      // x = s * scale * log2(e), p = 2^(x - m)
      const bool full = k0 + kBK <= a.sk &&
                        (!a.causal || k0 + kBK - 1 <= q0 + wr);  // none masked
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int q_pos = q0 + wr + g + 8 * h2;
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k_pos = k0 + nb * 8 + 2 * t + e;
            float& x = s[nb][2 * h2 + e];
            x = full || (k_pos < a.sk && (!a.causal || q_pos >= k_pos))
                ? x * scale2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h2], mx);
        // a row with every score masked so far keeps p = 0, never NaN
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[h2] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nb][2 * h2 + e];
            x = exp2f(x - m_use);
            sum += x;
          }
        l[h2] = l[h2] * alpha + sum;
        m[h2] = m_new;
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          acc[nd][2 * h2] *= alpha;
          acc[nd][2 * h2 + 1] *= alpha;
        }
      }

      // P V over the tile's 8-key blocks, keys relabelled: A's column t is
      // key 2t and column t + 4 is key 2t + 1, so a = (c0, c2, c1, c3) and
      // V's B fragment comes from V rows 2t (b0) and 2t + 1 (b1)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        pv_product<KD, LD, kLo>(acc, s[nb], Vs + nb * 8 * LD, g, t);
    }
    __syncthreads();   // every warp is done with this stage before its reuse
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lsum = l[h2];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int q_pos = q0 + wr + g + 8 * h2;
    if (q_pos < a.sq) {
      const float denom = fmaxf(lsum, 1e-30f);
      T* orow = oh + q_pos * a.os.s + 2 * t;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd)
        if (nd * 8 < a.d)
          store2(orow + nd * 8, acc[nd][2 * h2] / denom,
                 acc[nd][2 * h2 + 1] / denom);
      // log-sum-exp of the row's scaled scores, for the backward pass
      if (a.lse != nullptr && t == 0)
        a.lse[(size_t)bh * a.sq + q_pos] =
            (m[h2] == -INFINITY ? 0.f : m[h2] * 0.6931471805599453f) +
            logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// SIMT path (128 < D <= 512): float32 FMAs on the CUDA cores. 128 threads
// form 16 row groups of 8 (kTX) lanes; a group shares RQ q rows and splits
// the columns, so row max and row sum reduce with three xor shuffles.

template <int BQ, int BK, int DMAX>
struct SimtTiles {
  static constexpr int LD = DMAX + 4;   // q/k/v rows: float4-aligned, 4 banks apart
  static constexpr int LDP = BK + 1;    // probability rows
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)BQ * LD + 2 * (size_t)BK * LD + (size_t)BQ * LDP);
};

template <typename T, int BQ, int BK, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const Fwd<T> a) {
  constexpr int RQ = BQ / kTY;    // q rows per thread
  constexpr int CK = BK / kTX;    // score columns per thread
  constexpr int CD = DMAX / kTX;  // output columns per thread (at most)
  constexpr int LD = SimtTiles<BQ, BK, DMAX>::LD;
  constexpr int LDP = SimtTiles<BQ, BK, DMAX>::LDP;
  static_assert(RQ >= 1 && CK >= 1 && BQ % kTY == 0 && BK % kTX == 0, "tile shape");

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int n_qt = (a.sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * BQ;
  const int bi = bh / a.heads;
  const int head = bh - bi * a.heads;
  const int ty = threadIdx.x / kTX;
  const int tx = threadIdx.x % kTX;
  const int row0 = ty * RQ;       // first tile row of this thread
  const int d = a.d;
  const int cd = d / kTX;         // output columns this thread owns
  const T* kh = a.k + bi * a.ks.b + head * a.ks.h;
  const T* vh = a.v + bi * a.vs.b + head * a.vs.h;
  T* oh = a.o + bi * a.os.b + head * a.os.h;

  load_rows<BQ, DMAX, LD, kThreads>(Qs, a.q + bi * a.qs.b + head * a.qs.h,
                                    a.qs.s, q0, a.sq, d);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[r][j] = 0.f;
  }

  int n_kt = (a.sk + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    load_rows<BK, DMAX, LD, kThreads>(Ks, kh, a.ks.s, k0, a.sk, d);
    load_rows<BK, DMAX, LD, kThreads>(Vs, vh, a.vs.s, k0, a.sk, d);
    cp_async_commit();
    cp_async_wait<0>();
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
        const bool ok = k_pos < a.sk && (!a.causal || q_pos >= k_pos);
        s[r][c] = ok ? s[r][c] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
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
    if (q_pos < a.sq) {
      const float denom = fmaxf(l[r], 1e-30f);
      T* orow = oh + q_pos * a.os.s + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j)
        if (j < cd) store1(orow + kTX * j, acc[r][j] / denom);
      if (a.lse != nullptr && tx == 0)
        a.lse[(size_t)bh * a.sq + q_pos] =
            (m[r] == -INFINITY ? 0.f : m[r]) + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch

template <typename T, int DMAX>
const void* mma_kernel() {
  return reinterpret_cast<const void*>(flash_fwd_mma_kernel<T, DMAX>);
}

template <typename T, int BQ, int BK, int DMAX>
const void* simt_kernel() {
  return reinterpret_cast<const void*>(flash_fwd_simt_kernel<T, BQ, BK, DMAX>);
}

// One call's kernel, its block, its dynamic shared memory and path.
struct Plan {
  const void* kern;
  cudaError_t (*allow)();
  int threads;
  size_t smem;
  int rows;     // q rows per block
  int mma;      // 1: tensor-core path, 0: SIMT
};

template <typename T, int DMAX>
Plan mma_plan() {
  constexpr size_t kBytes = MmaTiles<DMAX>::bytes;
  return {mma_kernel<T, DMAX>(), allow_smem<mma_kernel<T, DMAX>, kBytes>,
          kMmaThreads, kBytes, kBQ, 1};
}

template <typename T, int BQ, int BK, int DMAX>
Plan simt_plan() {
  constexpr size_t kBytes = SimtTiles<BQ, BK, DMAX>::bytes;
  return {simt_kernel<T, BQ, BK, DMAX>(),
          allow_smem<simt_kernel<T, BQ, BK, DMAX>, kBytes>, kThreads, kBytes,
          BQ, 0};
}

// The path is chosen by the head dim alone.
template <typename T>
Plan plan_for(int d) {
  if (d <= 64) return mma_plan<T, 64>();
  if (d <= 128) return mma_plan<T, 128>();
  if (d <= 256) return simt_plan<T, 32, 32, 256>();
  return simt_plan<T, 16, 16, 512>();
}

template <typename T>
cudaError_t launch(const Fwd<T>& a, int bh, cudaStream_t stream, int* path) {
  const Plan p = plan_for<T>(a.d);
  if (path) *path = p.mma;
  cudaError_t e = p.allow();
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((a.sq + p.rows - 1) / p.rows) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  void* args[] = {const_cast<Fwd<T>*>(&a)};
  e = cudaLaunchKernel(p.kern, dim3((unsigned)blocks), dim3(p.threads), args,
                       p.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int d) {
  const Plan p = plan_for<T>(d);
  int blocks = 0;
  cudaError_t e = p.allow();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.kern,
                                                      p.threads, p.smem);
  return e == cudaSuccess ? blocks : -1;
}

bool valid_shape(int batch, int heads, int sq, int sk, int d) {
  return batch >= 1 && heads >= 1 && sq >= 1 && sk >= 1 && d >= 8 &&
         d <= 512 && d % 8 == 0 && (long long)batch * heads <= 0x7fffffffLL;
}

}  // namespace

// q (B, H, Sq, D), k and v (B, H, Sk, D), o (B, H, Sq, D) on the current
// device, each given by its element strides over (B, H, S) with stride 1
// on D; every row must start on 16 bytes (pointer and strides). dtype: 0
// float32, 1 bfloat16. lse, a dense (B, H, Sq) float32, receives each
// row's log-sum-exp of the scaled, masked scores; a null lse writes none
// (the serving path). *path (when not null) is set to 1 for the
// tensor-core path (D <= 128), 0 for the SIMT one.
extern "C" int mxtt_flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int dtype, void* stream, int* path) {
  if (!valid_shape(batch, heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (dtype == 0) {
    const Fwd<float> a{static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(o),
                       lse, qs, ks, vs, os, heads, sq, sk, d, scale, causal};
    return (int)launch(a, bh, s, path);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    const Fwd<B> a{static_cast<const B*>(q), static_cast<const B*>(k),
                   static_cast<const B*>(v), static_cast<B*>(o), lse, qs, ks,
                   vs, os, heads, sq, sk, d, scale, causal};
    return (int)launch(a, bh, s, path);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of the kernel that head dim d takes (dtype 0 float32, 1
// bfloat16) that fit on one SM at once, by the CUDA occupancy calculator;
// -1 on an error.
extern "C" int mxtt_flash_attention_blocks_per_sm(int d, int dtype) {
  if (d < 8 || d > 512 || d % 8) return -1;
  if (dtype == 0) return blocks_per_sm<float>(d);
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16>(d);
  return -1;
}
