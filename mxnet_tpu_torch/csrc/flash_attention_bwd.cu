// Flash attention backward for Hopper (sm_90a), float32 and bfloat16 inputs,
// on the tensor cores.
//
// Replaces mxnet_tpu/kernels/flash.py:_flash_backward, the blocked
// recompute that the JAX package runs as plain JAX beside its forward
// pallas_call (FlashAttention eq. 13-16). Given q, k, v, the forward's
// output o, its per-row natural-log log-sum-exp lse and the output gradient
// dO, with P = exp(scale * q k^T - lse) (masked), dP = dO v^T,
// D = rowsum(dO o) and dS = P (dP - D):
//
//   dq = scale * dS k,    dk = scale * dS^T q,    dv = P^T dO.
//
// Two deterministic kernels, no atomics, launched in this order on one
// stream; the (S, S) matrices never reach device memory:
//
// * dq: one block of 4 warps per (batch, head, 64 q rows), each warp 16
//   rows. It computes D for its rows (and writes it for the second kernel),
//   then streams k and v tiles, recomputing P and dP and accumulating dq.
// * dkv: one block of 4 warps per (batch, head, 64 keys), each warp 16
//   keys. It keeps its k and v rows in shared memory, streams q and dO tiles
//   with their lse and D, recomputes P^T and dP^T and accumulates dk and dv.
//
// Domain as the forward's: any S >= 1 (ragged tiles zero-filled and
// masked), Sq != Sk, causal aligned top-left (q_pos >= k_pos; tiles wholly
// masked are skipped), D a multiple of 8 up to 512, sums in float32, outputs
// in the input dtype. q, k, v, o and dO are read, and dq, dk and dv written,
// through their (B, H, S) element strides with D contiguous, so the
// (B, S, H, D) activations of a MultiHeadAttention and the gradients that
// flow back to them need no copy either way; lse and D are dense
// (B, H, Sq) float32.
//
// What bounds it: at the training shape (B*H = 384, S = 128, D = 64,
// float32) dq does 3 products and dkv 4, each 2*B*H*S*S*D = 0.81 GFLOP.
// As three TF32 products that is 7.2 and 9.7 GFLOP, 14.6 and 19.5 us at the
// tensor cores' 495 TFLOP/s, while each kernel moves 6 tensors of 12.6 MB
// (dq: q, k, v, o, dO in, dq out; dkv: q, k, v, dO in, dk, dv out) plus lse
// and D, 22.7 us at 3.35 TB/s: bytes bound both. (On the CUDA cores' 67
// TFLOP/s of float32 the two would need 36 and 48 us.)
//
// What the design does about it, D <= 128 (flash_mma.cuh has the pieces,
// shared with the forward):
// * Every product is one of the forward's two shapes on the tensor cores
//   (mma.sync m16n8k8 TF32, float32-accurate by the 3xTF32 split):
//   QK-shaped S = Q K^T and dP = dO V^T in dq, S^T = K Q^T and
//   dP^T = V dO^T in dkv; PV-shaped dq += dS K, dv += P^T dO and
//   dk += dS^T Q, the accumulator block relabelled as the A operand
//   (a = (c0, c2, c1, c3)) with B from rows 2t, 2t + 1 of K, dO or Q. P and
//   dS never leave registers. For bfloat16 the lo parts of q, k, v and dO
//   are zero and a compile-time flag (kLo) drops their products; P and dS
//   are float32 and keep both halves.
// * P = exp2(S * scale * log2 e - lse * log2 e) and dS = P (dP - D) are
//   computed in fragment coordinates. In dq, lse and D are per row (rows g,
//   g + 8: registers); in dkv per column (q rows 2t, 2t + 1 of each n8
//   block), read from the stage's copy in shared memory. Tiles with nothing
//   masked skip the mask; q rows past Sq give P = dS = 0 explicitly.
// * D is computed by the dq kernel before its loop from its dO tile and o
//   read at the A-fragment positions, summed over the row's four lanes.
// * Streamed tiles arrive by cp.async into a ring of two stages, the next
//   tile in flight while one is computed: k and v tiles of 32 keys in dq
//   (16 at D <= 128), q and dO tiles of 32 rows with their lse and D in dkv
//   (16 at D <= 128). Rows are padded to D + 4 floats (conflict-free
//   fragment reads) and columns past D are zero-filled, so the unrolled
//   products have no branch. bfloat16 tiles land as float32.
// * Registers: a warp's dq tile (16 x D) or dk and dv tiles (2 x 16 x D)
//   stay in registers as accumulators. The operands stay in shared memory
//   and are split where read: holding the dq kernel's q rows, or the dkv
//   kernel's k or v rows, as split A fragments too cost the third block
//   on an SM, which was faster on the card (PERF.md). At D <= 64 three
//   blocks (12 warps) share an SM, at D <= 128 two.
//
// D above 128 takes the SIMT kernels below (float32 FMAs on the CUDA cores,
// register-blocked), whose accumulators would not fit a warp's registers as
// mma fragments. Each launcher picks the path by D alone and reports it; it
// is never a fallback.
//
// The launch functions are plain C: each returns cudaGetLastError() after
// its launch and never synchronises.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mxtt_flash;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Bwd {
  const T* q;
  const T* k;
  const T* v;
  const T* o;      // dq kernel only
  const T* dout;
  const float* lse;
  float* dsum;     // written by dq, read by dkv
  T* dq;
  T* dk;
  T* dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int heads, sq, sk, d;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// Tensor-core path (D <= 128)

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // q rows (dq) or keys (dkv) per block

template <int DMAX>
struct DqMma {
  static constexpr int LD = DMAX + 4;
  static constexpr int BK = DMAX <= 64 ? 32 : 16;   // keys per k/v tile
  static constexpr int kStage = 2 * BK * LD;   // a k tile, then its v tile
  // stage 0, stage 1, the dO tile, the q tile
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)kStage + 2 * (size_t)kRows * LD);
  // 3 blocks (166 registers, 70 KB) at D <= 64; at D <= 128 shared memory
  // allows 2
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : 2;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kMmaThreads, DqMma<DMAX>::kMinBlocks)
flash_bwd_dq_mma_kernel(const Bwd<T> a) {
  using Tl = DqMma<DMAX>;
  constexpr int LD = Tl::LD;
  constexpr int BK = Tl::BK;
  constexpr int NB = BK / 8;     // n8 blocks of scores in a k tile
  constexpr int KD = DMAX / 8;   // k8 steps over D, n8 blocks of dq
  constexpr bool kLo = std::is_same<T, float>::value;

  extern __shared__ float4 smem_f4[];
  float* const stages = reinterpret_cast<float*>(smem_f4);
  float* const dOs = stages + 2 * Tl::kStage;
  float* const Qs = dOs + kRows * LD;

  const int n_qt = (a.sq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kRows;
  const int bi = bh / a.heads;
  const int head = bh - bi * a.heads;
  const T* kh = a.k + bi * a.ks.b + head * a.ks.h;
  const T* vh = a.v + bi * a.vs.b + head * a.vs.h;
  const T* oh = a.o + bi * a.os.b + head * a.os.h;
  T* dqh = a.dq + bi * a.dqs.b + head * a.dqs.h;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;   // the warp's first tile row

  int n_kt = (a.sk + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + kRows + BK - 1) / BK);

  auto load_kv = [&](int kt) {
    float* ks = stages + (kt & 1) * Tl::kStage;
    load_rows<BK, DMAX, LD, kMmaThreads>(ks, kh, a.ks.s, kt * BK, a.sk, a.d);
    load_rows<BK, DMAX, LD, kMmaThreads>(ks + BK * LD, vh, a.vs.s, kt * BK,
                                         a.sk, a.d);
  };

  load_rows<kRows, DMAX, LD, kMmaThreads>(
      Qs, a.q + bi * a.qs.b + head * a.qs.h, a.qs.s, q0, a.sq, a.d);
  load_rows<kRows, DMAX, LD, kMmaThreads>(
      dOs, a.dout + bi * a.dos.b + head * a.dos.h, a.dos.s, q0, a.sq, a.d);
  cp_async_commit();
  load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();   // the q and dO tiles
  __syncthreads();

  // D = rowsum(dO o) of rows g (h2 = 0) and g + 8 (h2 = 1): this lane's
  // columns 8 kk + t and + 4 (its A-fragment positions), then the row's
  // four lanes; lse in base 2
  float Dr[2], L2[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = wr + g + 8 * h2;
    const int q_pos = q0 + row;
    float part = 0.f;
    if (q_pos < a.sq) {
      const T* orow = oh + q_pos * a.os.s + t;
      const float* drow = dOs + row * LD + t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        if (kk * 8 < a.d) {
          part = fmaf(drow[kk * 8], load1(orow + kk * 8), part);
          part = fmaf(drow[kk * 8 + 4], load1(orow + kk * 8 + 4), part);
        }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    Dr[h2] = part;
    L2[h2] = q_pos < a.sq ? a.lse[(size_t)bh * a.sq + q_pos] * kLog2e : 0.f;
    if (t == 0 && q_pos < a.sq) a.dsum[(size_t)bh * a.sq + q_pos] = part;
  }

  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  const float scale2 = a.scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();   // k tile kt has landed
    __syncthreads();
    const int k0 = kt * BK;
    const float* Ks = stages + (kt & 1) * Tl::kStage;
    const float* Vs = Ks + BK * LD;
    // causal: every score of this tile lies above all 16 rows of the warp
    if (!a.causal || k0 <= q0 + wr + 15) {
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;

#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[4], al[4];
        a_fragment<LD, kLo>(Qs, wr, kk, g, t, ah, al);
        qk_step<NB, LD, kLo>(s, ah, al, Ks, kk, g, t);    // S = Q K^T
        a_fragment<LD, kLo>(dOs, wr, kk, g, t, ah, al);
        qk_step<NB, LD, kLo>(dp, ah, al, Vs, kk, g, t);   // dP = dO V^T
      }

      // P and dS on rows g (h2 = 0) and g + 8, keys k0 + 8 nb + 2t (+ 1);
      // dS replaces S
      const bool full = k0 + BK <= a.sk &&
                        (!a.causal || k0 + BK - 1 <= q0 + wr);  // none masked
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h2 = i >> 1;
          const int q_pos = q0 + wr + g + 8 * h2;
          const int k_pos = k0 + nb * 8 + 2 * t + (i & 1);
          const bool ok =
              full || (k_pos < a.sk && (!a.causal || q_pos >= k_pos));
          const float p = ok ? exp2f(fmaf(s[nb][i], scale2, -L2[h2])) : 0.f;
          s[nb][i] = p * (dp[nb][i] - Dr[h2]);
        }

      // dq += dS K, the 8 keys of each n8 block relabelled
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        pv_product<KD, LD, kLo>(acc, s[nb], Ks + nb * 8 * LD, g, t);
    }
    __syncthreads();   // every warp is done with this stage before its reuse
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int q_pos = q0 + wr + g + 8 * h2;
    if (q_pos < a.sq) {
      T* row = dqh + q_pos * a.dqs.s + 2 * t;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd)
        if (nd * 8 < a.d)
          store2(row + nd * 8, acc[nd][2 * h2] * a.scale,
                 acc[nd][2 * h2 + 1] * a.scale);
    }
  }
}

template <int DMAX>
struct DkvMma {
  static constexpr int LD = DMAX + 4;
  static constexpr int BQ = DMAX <= 64 ? 32 : 16;   // q rows per q/dO tile
  // a q tile, its dO tile, then the lse and D of its rows
  static constexpr int kStage = 2 * BQ * LD + 2 * BQ;
  // the block's k and v rows, then stages 0 and 1
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)kRows * LD + 2 * (size_t)kStage);
  // 3 blocks (168 registers, 70 KB) at D <= 64; at D <= 128 the two 16 x D
  // accumulators would spill at 3
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : 2;
  static_assert(kStage % 4 == 0, "stages start on 16 bytes");
  static_assert(2 * BQ <= kMmaThreads, "one thread per row statistic");
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kMmaThreads, DkvMma<DMAX>::kMinBlocks)
flash_bwd_dkv_mma_kernel(const Bwd<T> a) {
  using Tl = DkvMma<DMAX>;
  constexpr int LD = Tl::LD;
  constexpr int BQ = Tl::BQ;
  constexpr int NB = BQ / 8;     // n8 blocks of scores in a q tile
  constexpr int KD = DMAX / 8;   // k8 steps over D, n8 blocks of dk and dv
  constexpr bool kLo = std::is_same<T, float>::value;

  extern __shared__ float4 smem_f4[];
  float* const Ks = reinterpret_cast<float*>(smem_f4);
  float* const Vs = Ks + kRows * LD;
  float* const stages = Vs + kRows * LD;

  const int n_kt = (a.sk + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - bh * n_kt) * kRows;
  const int bi = bh / a.heads;
  const int head = bh - bi * a.heads;
  const T* qh = a.q + bi * a.qs.b + head * a.qs.h;
  const T* doh = a.dout + bi * a.dos.b + head * a.dos.h;
  const float* lh = a.lse + (size_t)bh * a.sq;
  const float* dh = a.dsum + (size_t)bh * a.sq;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw = (threadIdx.x >> 5) * 16;   // the warp's first key row

  const int n_qt = (a.sq + BQ - 1) / BQ;
  // causal: q tiles wholly before this block's keys see none of them
  const int qt_first = a.causal ? k0 / BQ : 0;

  // q tile qt, its dO tile and its rows' lse and D into stage `slot`
  auto load_q = [&](int qt, int slot) {
    float* st = stages + slot * Tl::kStage;
    const int r0 = qt * BQ;
    load_rows<BQ, DMAX, LD, kMmaThreads>(st, qh, a.qs.s, r0, a.sq, a.d);
    load_rows<BQ, DMAX, LD, kMmaThreads>(st + BQ * LD, doh, a.dos.s, r0,
                                         a.sq, a.d);
    if (threadIdx.x < 2 * BQ) {
      const int i = threadIdx.x % BQ;
      const float* src = (threadIdx.x < BQ ? lh : dh) + r0 + i;
      const bool in = r0 + i < a.sq;
      cp_async4((uint32_t)__cvta_generic_to_shared(st + 2 * BQ * LD +
                                                   threadIdx.x),
                in ? src : lh, in ? 4 : 0);
    }
  };

  load_rows<kRows, DMAX, LD, kMmaThreads>(
      Ks, a.k + bi * a.ks.b + head * a.ks.h, a.ks.s, k0, a.sk, a.d);
  load_rows<kRows, DMAX, LD, kMmaThreads>(
      Vs, a.v + bi * a.vs.b + head * a.vs.h, a.vs.s, k0, a.sk, a.d);
  load_q(qt_first, 0);
  cp_async_commit();

  float dk[KD][4], dv[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  const float scale2 = a.scale * kLog2e;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int slot = (qt - qt_first) & 1;
    if (qt + 1 < n_qt) load_q(qt + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // q tile qt (and the k, v rows) have landed
    __syncthreads();
    const int q0 = qt * BQ;
    const float* Qs = stages + slot * Tl::kStage;
    const float* dOs = Qs + BQ * LD;
    const float* Ls = dOs + BQ * LD;
    const float* Ds = Ls + BQ;
    // causal: some q row of the tile sees some key of the warp
    if (!a.causal || q0 + BQ - 1 >= k0 + kw) {
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;

#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[4], al[4];
        a_fragment<LD, kLo>(Ks, kw, kk, g, t, ah, al);
        qk_step<NB, LD, kLo>(s, ah, al, Qs, kk, g, t);     // S^T = K Q^T
        a_fragment<LD, kLo>(Vs, kw, kk, g, t, ah, al);
        qk_step<NB, LD, kLo>(dp, ah, al, dOs, kk, g, t);   // dP^T = V dO^T
      }

      // P^T (replacing S^T) and dS^T (replacing dP^T) on keys g (i < 2) and
      // g + 8, q rows q0 + 8 nb + 2t (+ 1), whose lse and D come from the
      // stage
      const bool full = q0 + BQ <= a.sq && k0 + kw + 16 <= a.sk &&
                        (!a.causal || q0 >= k0 + kw + 15);  // none masked
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float2 lse2 = *reinterpret_cast<const float2*>(Ls + nb * 8 + 2 * t);
        const float2 dd = *reinterpret_cast<const float2*>(Ds + nb * 8 + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          const int k_pos = k0 + kw + g + 8 * (i >> 1);
          const int q_pos = q0 + nb * 8 + 2 * t + e;
          const bool ok = full || (q_pos < a.sq && k_pos < a.sk &&
                                   (!a.causal || q_pos >= k_pos));
          const float nl = -(e ? lse2.y : lse2.x) * kLog2e;
          const float p = ok ? exp2f(fmaf(s[nb][i], scale2, nl)) : 0.f;
          s[nb][i] = p;
          dp[nb][i] = p * (dp[nb][i] - (e ? dd.y : dd.x));
        }
      }

      // dv += P^T dO and dk += dS^T Q, the 8 q rows of each n8 block
      // relabelled
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        pv_product<KD, LD, kLo>(dv, s[nb], dOs + nb * 8 * LD, g, t);
        pv_product<KD, LD, kLo>(dk, dp[nb], Qs + nb * 8 * LD, g, t);
      }
    }
    __syncthreads();   // every warp is done with this stage before its reuse
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int k_pos = k0 + kw + g + 8 * h2;
    if (k_pos < a.sk) {
      T* dkrow = a.dk + bi * a.dks.b + head * a.dks.h + k_pos * a.dks.s + 2 * t;
      T* dvrow = a.dv + bi * a.dvs.b + head * a.dvs.h + k_pos * a.dvs.s + 2 * t;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd)
        if (nd * 8 < a.d) {
          store2(dkrow + nd * 8, dk[nd][2 * h2] * a.scale,
                 dk[nd][2 * h2 + 1] * a.scale);
          store2(dvrow + nd * 8, dv[nd][2 * h2], dv[nd][2 * h2 + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// SIMT path (128 < D <= 512): float32 FMAs on the CUDA cores. 128 threads
// form 16 row groups of 8 (kTX) lanes; a group shares RQ rows and splits
// the columns.

template <int BQ, int BK, int DMAX>
struct DqTiles {
  static constexpr int LD = DMAX + 4;
  static constexpr int LDS = BK + 1;
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)BQ * LD + 2 * (size_t)BK * LD + (size_t)BQ * LDS);
};

template <typename T, int BQ, int BK, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt_kernel(const Bwd<T> a) {
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

  const int n_qt = (a.sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * BQ;
  const int bi = bh / a.heads;
  const int head = bh - bi * a.heads;
  const int ty = threadIdx.x / kTX;
  const int tx = threadIdx.x % kTX;
  const int row0 = ty * RQ;
  const int d = a.d;
  const int cd = d / kTX;
  const T* kh = a.k + bi * a.ks.b + head * a.ks.h;
  const T* vh = a.v + bi * a.vs.b + head * a.vs.h;
  const T* oh = a.o + bi * a.os.b + head * a.os.h;
  T* dqh = a.dq + bi * a.dqs.b + head * a.dqs.h;

  load_rows<BQ, DMAX, LD, kThreads>(Qs, a.q + bi * a.qs.b + head * a.qs.h,
                                    a.qs.s, q0, a.sq, d);
  load_rows<BQ, DMAX, LD, kThreads>(
      dOs, a.dout + bi * a.dos.b + head * a.dos.h, a.dos.s, q0, a.sq, d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // D = rowsum(dO o) and the saved lse of this thread's rows
  float Drow[RQ], L[RQ], acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int q_pos = q0 + row0 + r;
    float part = 0.f;
    if (q_pos < a.sq)
      for (int c = tx; c < d; c += kTX)
        part = fmaf(dOs[(row0 + r) * LD + c], load1(oh + q_pos * a.os.s + c),
                    part);
    Drow[r] = group_sum(part);
    L[r] = q_pos < a.sq ? a.lse[(size_t)bh * a.sq + q_pos] : 0.f;
    if (tx == 0 && q_pos < a.sq) a.dsum[(size_t)bh * a.sq + q_pos] = Drow[r];
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[r][j] = 0.f;
  }

  int n_kt = (a.sk + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/dSs
    load_rows<BK, DMAX, LD, kThreads>(Ks, kh, a.ks.s, k0, a.sk, d);
    load_rows<BK, DMAX, LD, kThreads>(Vs, vh, a.vs.s, k0, a.sk, d);
    cp_async_commit();
    cp_async_wait<0>();
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
        const bool ok = q_pos < a.sq && k_pos < a.sk && (!a.causal || q_pos >= k_pos);
        const float p = ok ? expf(s[r][c] * a.scale - L[r]) : 0.f;
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
    if (q_pos < a.sq) {
      T* row = dqh + q_pos * a.dqs.s + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j)
        if (j < cd) store1(row + kTX * j, acc[r][j] * a.scale);
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
flash_bwd_dkv_simt_kernel(const Bwd<T> a) {
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

  const int n_kt = (a.sk + BK - 1) / BK;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - bh * n_kt) * BK;
  const int bi = bh / a.heads;
  const int head = bh - bi * a.heads;
  const int ty = threadIdx.x / kTX;
  const int tx = threadIdx.x % kTX;
  const int row0 = ty * RK;
  const int d = a.d;
  const int cd = d / kTX;
  const T* qh = a.q + bi * a.qs.b + head * a.qs.h;
  const T* doh = a.dout + bi * a.dos.b + head * a.dos.h;
  const float* lh = a.lse + (size_t)bh * a.sq;
  const float* dh = a.dsum + (size_t)bh * a.sq;

  load_rows<BK, DMAX, LD, kThreads>(Ks, a.k + bi * a.ks.b + head * a.ks.h,
                                    a.ks.s, k0, a.sk, d);
  load_rows<BK, DMAX, LD, kThreads>(Vs, a.v + bi * a.vs.b + head * a.vs.h,
                                    a.vs.s, k0, a.sk, d);
  cp_async_commit();

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int j = 0; j < CD; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  const int n_qt = (a.sq + BQ - 1) / BQ;
  // causal: q tiles wholly before this k tile see none of its keys
  const int qt_first = a.causal ? k0 / BQ : 0;

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_rows<BQ, DMAX, LD, kThreads>(Qs, qh, a.qs.s, q0, a.sq, d);
    load_rows<BQ, DMAX, LD, kThreads>(dOs, doh, a.dos.s, q0, a.sq, d);
    cp_async_commit();
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < a.sq;
      Ls[i] = in ? lh[q0 + i] : 0.f;
      Ds[i] = in ? dh[q0 + i] : 0.f;
    }
    cp_async_wait<0>();
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
        const bool ok = q_pos < a.sq && k_pos < a.sk && (!a.causal || q_pos >= k_pos);
        const float p = ok ? expf(s[r][c] * a.scale - Ls[qi]) : 0.f;
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
  cp_async_wait<0>();   // the k and v rows, where no q tile was loaded

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int k_pos = k0 + row0 + r;
    if (k_pos < a.sk) {
      T* dkrow = a.dk + bi * a.dks.b + head * a.dks.h + k_pos * a.dks.s + tx;
      T* dvrow = a.dv + bi * a.dvs.b + head * a.dvs.h + k_pos * a.dvs.s + tx;
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        if (j < cd) {
          store1(dkrow + kTX * j, dk_acc[r][j] * a.scale);
          store1(dvrow + kTX * j, dv_acc[r][j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch

template <typename T, int DMAX>
const void* dq_mma_kernel() {
  return reinterpret_cast<const void*>(flash_bwd_dq_mma_kernel<T, DMAX>);
}

template <typename T, int DMAX>
const void* dkv_mma_kernel() {
  return reinterpret_cast<const void*>(flash_bwd_dkv_mma_kernel<T, DMAX>);
}

template <typename T, int BQ, int BK, int DMAX>
const void* dq_simt_kernel() {
  return reinterpret_cast<const void*>(flash_bwd_dq_simt_kernel<T, BQ, BK, DMAX>);
}

template <typename T, int BK, int BQ, int DMAX>
const void* dkv_simt_kernel() {
  return reinterpret_cast<const void*>(flash_bwd_dkv_simt_kernel<T, BK, BQ, DMAX>);
}

// One call's kernel, its block, its dynamic shared memory and path.
struct Plan {
  const void* kern;
  cudaError_t (*allow)();
  int threads;
  size_t smem;
  int rows;     // q rows (dq) or keys (dkv) per block
  int mma;      // 1: tensor-core path, 0: SIMT
};

template <typename T, int DMAX>
Plan dq_mma_plan() {
  constexpr size_t kBytes = DqMma<DMAX>::bytes;
  return {dq_mma_kernel<T, DMAX>(), allow_smem<dq_mma_kernel<T, DMAX>, kBytes>,
          kMmaThreads, kBytes, kRows, 1};
}

template <typename T, int DMAX>
Plan dkv_mma_plan() {
  constexpr size_t kBytes = DkvMma<DMAX>::bytes;
  return {dkv_mma_kernel<T, DMAX>(), allow_smem<dkv_mma_kernel<T, DMAX>, kBytes>,
          kMmaThreads, kBytes, kRows, 1};
}

template <typename T, int BQ, int BK, int DMAX>
Plan dq_simt_plan() {
  constexpr size_t kBytes = DqTiles<BQ, BK, DMAX>::bytes;
  return {dq_simt_kernel<T, BQ, BK, DMAX>(),
          allow_smem<dq_simt_kernel<T, BQ, BK, DMAX>, kBytes>, kThreads,
          kBytes, BQ, 0};
}

template <typename T, int BK, int BQ, int DMAX>
Plan dkv_simt_plan() {
  constexpr size_t kBytes = DkvTiles<BK, BQ, DMAX>::bytes;
  return {dkv_simt_kernel<T, BK, BQ, DMAX>(),
          allow_smem<dkv_simt_kernel<T, BK, BQ, DMAX>, kBytes>, kThreads,
          kBytes, BK, 0};
}

// The path is chosen by the head dim alone. SIMT tiles per head-dim bucket
// keep the per-thread accumulators at 32-128 floats.
template <typename T>
Plan dq_plan(int d) {
  if (d <= 64) return dq_mma_plan<T, 64>();
  if (d <= 128) return dq_mma_plan<T, 128>();
  if (d <= 256) return dq_simt_plan<T, 32, 32, 256>();
  return dq_simt_plan<T, 16, 16, 512>();
}

template <typename T>
Plan dkv_plan(int d) {
  if (d <= 64) return dkv_mma_plan<T, 64>();
  if (d <= 128) return dkv_mma_plan<T, 128>();
  if (d <= 256) return dkv_simt_plan<T, 32, 32, 256>();
  return dkv_simt_plan<T, 16, 16, 512>();
}

template <typename T>
cudaError_t launch(const Plan& p, const Bwd<T>& a, int bh, int n,
                   cudaStream_t stream, int* path) {
  if (path) *path = p.mma;
  cudaError_t e = p.allow();
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((n + p.rows - 1) / p.rows) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  void* args[] = {const_cast<Bwd<T>*>(&a)};
  e = cudaLaunchKernel(p.kern, dim3((unsigned)blocks), dim3(p.threads), args,
                       p.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int occupancy(const Plan& p) {
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

template <typename T>
Bwd<T> args(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const float* lse, float* dsum, void* dq,
            void* dk, void* dv, const Strides (&st)[8], int heads, int sq,
            int sk, int d, float scale, int causal) {
  return {static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq),
          static_cast<T*>(dk), static_cast<T*>(dv), st[0], st[1], st[2],
          st[3], st[4], st[5], st[6], st[7], heads, sq, sk, d, scale, causal};
}

}  // namespace

// q, o, dout, dq (B, H, Sq, D); k, v (B, H, Sk, D) on the current device,
// each given by its element strides over (B, H, S) with stride 1 on D;
// every row must start on 16 bytes (pointer and strides). lse and dsum are
// dense (B, H, Sq) float32. Writes dq and dsum = rowsum(dout * o). dtype: 0
// float32, 1 bfloat16. *path (when not null) is set to 1 for the
// tensor-core path (D <= 128), 0 for the SIMT one.
extern "C" int mxtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, float* dsum,
    int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    float scale, int causal, int dtype, void* stream, int* path) {
  if (!valid_shape(batch, heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const Strides st[8] = {{q_sb, q_sh, q_ss},    {k_sb, k_sh, k_ss},
                         {v_sb, v_sh, v_ss},    {o_sb, o_sh, o_ss},
                         {do_sb, do_sh, do_ss}, {dq_sb, dq_sh, dq_ss},
                         {0, 0, 0},             {0, 0, 0}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (dtype == 0)
    return (int)launch(dq_plan<float>(d),
                       args<float>(q, k, v, o, dout, lse, dsum, dq, nullptr,
                                   nullptr, st, heads, sq, sk, d, scale,
                                   causal),
                       bh, sq, s, path);
  if (dtype == 1)
    return (int)launch(dq_plan<__nv_bfloat16>(d),
                       args<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq,
                                           nullptr, nullptr, st, heads, sq,
                                           sk, d, scale, causal),
                       bh, sq, s, path);
  return (int)cudaErrorInvalidValue;
}

// Same layout rules; reads the dsum that mxtt_flash_attention_bwd_dq wrote
// (launch it first, on the same stream) and writes dk and dv (B, H, Sk, D)
// through their strides.
extern "C" int mxtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, void* dk, void* dv,
    int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, int causal, int dtype, void* stream, int* path) {
  if (!valid_shape(batch, heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const Strides st[8] = {{q_sb, q_sh, q_ss},    {k_sb, k_sh, k_ss},
                         {v_sb, v_sh, v_ss},    {0, 0, 0},
                         {do_sb, do_sh, do_ss}, {0, 0, 0},
                         {dk_sb, dk_sh, dk_ss}, {dv_sb, dv_sh, dv_ss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  float* ds = const_cast<float*>(dsum);
  if (dtype == 0)
    return (int)launch(dkv_plan<float>(d),
                       args<float>(q, k, v, nullptr, dout, lse, ds, nullptr,
                                   dk, dv, st, heads, sq, sk, d, scale,
                                   causal),
                       bh, sk, s, path);
  if (dtype == 1)
    return (int)launch(dkv_plan<__nv_bfloat16>(d),
                       args<__nv_bfloat16>(q, k, v, nullptr, dout, lse, ds,
                                           nullptr, dk, dv, st, heads, sq, sk,
                                           d, scale, causal),
                       bh, sk, s, path);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the dq (which 0) or dkv (which 1) kernel that head dim d takes
// (dtype 0 float32, 1 bfloat16) that fit on one SM at once, by the CUDA
// occupancy calculator; -1 on an error.
extern "C" int mxtt_flash_attention_bwd_blocks_per_sm(int which, int d,
                                                      int dtype) {
  if (d < 8 || d > 512 || d % 8 || which < 0 || which > 1) return -1;
  if (dtype == 0) return occupancy(which ? dkv_plan<float>(d) : dq_plan<float>(d));
  if (dtype == 1)
    return occupancy(which ? dkv_plan<__nv_bfloat16>(d)
                           : dq_plan<__nv_bfloat16>(d));
  return -1;
}
