// Fused multi-tensor optimizer steps for Hopper (sm_90a): SGD with momentum
// and Adam, float32.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/opt_step.py: _sgd_mom_body
// (K1, via _kernel_sgd) and _adam_body (K2, via _kernel_adam), both run by
// _run's pallas_call once per parameter. Here ONE launch updates every
// parameter of a step. The learning rate is read from a device scalar, so
// lr schedules and Adam's bias correction (folded into lr by the caller)
// never sync the host. A non-null `skip` device flag that is non-zero makes
// the launch leave every buffer untouched (the trainer's non-finite guard).
//
// What bounds it: device memory. Every operand is read once and the
// updated ones written once: SGD-momentum moves 20 bytes per parameter
// (w, g, m read; w, m written), Adam 28 (w, g, mean, var read; w, mean,
// var written), 0.65 and 0.91 ms for BERT-base's 109 M parameters at
// 3.35 TB/s. The design keeps the card's memory system full to the end:
//
// * 16 bytes a thread. A tensor whose operand pointers are all 16-byte
//   aligned (one flag per table row, from the OR of its pointers) moves
//   every operand as float4; its ragged tail (n % 4 elements) and every
//   tensor with a misaligned operand take a scalar loop in the same launch.
// * Many bytes in flight. Each thread issues the loads of kUnroll float4
//   groups of every operand before any arithmetic or store, from
//   __restrict__ pointers; the read-once gradient is loaded with __ldcs
//   (evict first) and every result stored with __stcs. With 2 blocks of
//   256 threads per SM that is 96 KB (SGD) or 128 KB (Adam) in flight per
//   SM, against the ~18 KB that 3.35 TB/s at ~0.7 us latency needs.
// * An even split over a compact window. The step's elements are
//   numbered as one flat sequence of 4-element groups (each tensor
//   starts a new group) and cut into tiles of kTileGroups groups, one
//   pass of every thread. One persistent wave of blocks (occupancy x
//   SMs, asked once per device) deals the tiles round-robin, so every
//   block gets the same number of tiles, +-1 of ~100, and all blocks
//   stream through one compact window of each operand. (One equal
//   contiguous range per block ran ~15% slower on an H100: with the
//   write streams spread over the whole 3 GB the memory system loses
//   bandwidth.) The wrapper builds, with the table, the index of the row
//   each tile starts in, so no block searches the table before a tile's
//   first data load.
//
// Numerics: bit-exact against the plain PyTorch versions
// (mxnet_tpu_torch/ops/optimizer_op.py) for float32, on either path. Every
// operation is a correctly rounded intrinsic in the op order of
// optimizer_op.py, so the global -O3 build (which contracts a*b+c into FMA
// by default) cannot fuse two roundings into one. Scalar constants such as
// (1 - beta1) are computed by the caller in double and rounded once to
// float, as PyTorch rounds a Python scalar. The clip propagates NaN as
// torch.clamp does.
//
// The launch functions are plain C: each returns cudaGetLastError() after
// its launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // float4 groups per operand in flight
constexpr int kMinBlocksPerSM = 2;
constexpr int kTileGroups = kUnroll * kThreads;  // as TILE_GROUPS in Python

// One row of the device table; the Python wrapper packs the same 56-byte
// layout (kernels/opt_step.py:TABLE_DTYPE).
struct TensorDesc {
  float* w;
  const float* g;
  float* s0;          // momentum (SGD) or mean (Adam)
  float* s1;          // variance (Adam); null for SGD
  long long n;        // elements
  long long begin;    // its first group in the step's flat group sequence
  float wd;
  int vec;            // 1: every operand 16-byte aligned
};
static_assert(sizeof(TensorDesc) == 56, "table row layout");

__device__ __forceinline__ float clip_nan(float g, float c) {
  return g != g ? g : fminf(fmaxf(g, -c), c);
}

// w' = w + m',  m' = momentum*m - lr*(g + wd*w),  g = clip(rescale*grad)
struct Sgd {
  static constexpr bool kVar = false;
  float momentum, rescale, clip;

  __device__ __forceinline__ void operator()(float& w, float grad, float& m,
                                             float&, float wd,
                                             float lr) const {
    float g = __fmul_rn(grad, rescale);
    if (clip > 0.f) g = clip_nan(g, clip);
    m = __fsub_rn(__fmul_rn(momentum, m),
                  __fmul_rn(lr, __fadd_rn(g, __fmul_rn(wd, w))));
    w = __fadd_rn(w, m);
  }
};

// g = clip(rescale*grad + wd*w); mean' = b1*mean + (1-b1)*g;
// var' = b2*var + (1-b2)*g*g; w' = w - (lr*mean') / (sqrt(var') + eps)
struct Adam {
  static constexpr bool kVar = true;
  float beta1, one_minus_beta1, beta2, one_minus_beta2, epsilon, rescale,
      clip;

  __device__ __forceinline__ void operator()(float& w, float grad,
                                             float& mean, float& var,
                                             float wd, float lr) const {
    float g = __fadd_rn(__fmul_rn(grad, rescale), __fmul_rn(wd, w));
    if (clip > 0.f) g = clip_nan(g, clip);
    mean = __fadd_rn(__fmul_rn(beta1, mean), __fmul_rn(one_minus_beta1, g));
    var = __fadd_rn(__fmul_rn(beta2, var),
                    __fmul_rn(one_minus_beta2, __fmul_rn(g, g)));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, mean),
                               __fadd_rn(__fsqrt_rn(var), epsilon)));
  }
};

template <typename Op>
__device__ __forceinline__ void apply4(const Op& op, float4& w,
                                       const float4& g, float4& a, float4& b,
                                       float wd, float lr) {
  op(w.x, g.x, a.x, b.x, wd, lr);
  op(w.y, g.y, a.y, b.y, wd, lr);
  op(w.z, g.z, a.z, b.z, wd, lr);
  op(w.w, g.w, a.w, b.w, wd, lr);
}

// Groups [g0, g1) of an aligned tensor, all of them whole.
template <typename Op>
__device__ __forceinline__ void run_vec(const TensorDesc& t, long long g0,
                                        long long g1, float lr,
                                        const Op& op) {
  float4* __restrict__ w = reinterpret_cast<float4*>(t.w);
  const float4* __restrict__ g = reinterpret_cast<const float4*>(t.g);
  float4* __restrict__ s0 = reinterpret_cast<float4*>(t.s0);
  float4* __restrict__ s1 = reinterpret_cast<float4*>(t.s1);
  const float wd = t.wd;
  for (long long base = g0 + threadIdx.x; base < g1;
       base += (long long)kUnroll * kThreads) {
    float4 rw[kUnroll], rg[kUnroll], ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < g1) {
        rw[u] = w[i];
        rg[u] = __ldcs(g + i);
        ra[u] = s0[i];
        if constexpr (Op::kVar) rb[u] = s1[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < g1) {
        apply4(op, rw[u], rg[u], ra[u], rb[u], wd, lr);
        __stcs(w + i, rw[u]);
        __stcs(s0 + i, ra[u]);
        if constexpr (Op::kVar) __stcs(s1 + i, rb[u]);
      }
    }
  }
}

// Elements [e0, e1) one by one: a misaligned tensor, or an aligned one's
// ragged tail.
template <typename Op>
__device__ __forceinline__ void run_scalar(const TensorDesc& t, long long e0,
                                           long long e1, float lr,
                                           const Op& op) {
  float* __restrict__ w = t.w;
  const float* __restrict__ g = t.g;
  float* __restrict__ s0 = t.s0;
  float* __restrict__ s1 = t.s1;
  const float wd = t.wd;
#pragma unroll 4
  for (long long i = e0 + threadIdx.x; i < e1; i += kThreads) {
    float rw = w[i], ra = s0[i], rb = 0.f;
    if constexpr (Op::kVar) rb = s1[i];
    op(rw, __ldcs(g + i), ra, rb, wd, lr);
    w[i] = rw;
    s0[i] = ra;
    if constexpr (Op::kVar) s1[i] = rb;
  }
}

// The step's flat group sequence is cut into tiles of kTileGroups groups
// (one pass of run_vec: kUnroll groups of every thread); block b takes
// tiles b, b + B, b + 2B, ... of the B blocks, so that at any moment the
// card works on one compact window of each operand. first[tile] is the
// row holding the tile's first group; each tile walks the rows it
// touches. The next tile's row index is loaded before this tile's data.
template <typename Op>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
opt_step_kernel(const TensorDesc* __restrict__ table,
                const int* __restrict__ first, int n_tensors,
                long long n_groups, const float* __restrict__ lr_ptr,
                const float* __restrict__ skip, Op op) {
  if (skip != nullptr && *skip != 0.f) return;
  const float lr = *lr_ptr;
  const long long n_tiles = (n_groups + kTileGroups - 1) / kTileGroups;
  long long tile = blockIdx.x;
  int k = tile < n_tiles ? first[tile] : n_tensors;
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    const int k_next = next < n_tiles ? first[next] : n_tensors;
    const long long lo = tile * kTileGroups;
    const long long hi = lo + kTileGroups < n_groups ? lo + kTileGroups
                                                     : n_groups;
    for (; k < n_tensors; ++k) {
      const TensorDesc t = table[k];
      if (t.begin >= hi) break;
      const long long g0 = (lo > t.begin ? lo : t.begin) - t.begin;
      const long long end = t.begin + (t.n + 3) / 4;
      const long long g1 = (hi < end ? hi : end) - t.begin;
      if (!t.vec) {
        run_scalar(t, 4 * g0, 4 * g1 < t.n ? 4 * g1 : t.n, lr, op);
        continue;
      }
      const long long whole = t.n / 4;
      run_vec(t, g0, g1 < whole ? g1 : whole, lr, op);
      if (g1 > whole) run_scalar(t, 4 * whole, t.n, lr, op);
    }
    k = k_next;
  }
}

template <typename Op>
int wave(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, opt_step_kernel<Op>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <typename Op>
int launch(const void* table, const int* first, int n_tensors,
           long long n_groups, int n_blocks, const float* lr,
           const float* skip, const Op& op, void* stream) {
  if (n_tensors < 1 || n_blocks < 1 || n_groups < 1)
    return (int)cudaErrorInvalidValue;
  opt_step_kernel<Op><<<n_blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TensorDesc*>(table), first, n_tensors, n_groups, lr,
      skip, op);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of one full wave of the family's kernel on the current device
// (adam: 0 for SGD-momentum, 1 for Adam): the wrapper asks once per device.
extern "C" int mxtt_opt_wave(int adam, int* blocks) {
  return adam ? wave<Adam>(blocks) : wave<Sgd>(blocks);
}

// table: n_tensors TensorDesc rows in device memory, begin ascending from
// 0 by ceil(n / 4); n_groups = sum of ceil(n / 4); first: one int per
// tile of kTileGroups groups in device memory, first[t] the row holding
// group t * kTileGroups; n_blocks: at most one full wave (mxtt_opt_wave).
// lr and skip are float32 device scalars (skip may be null).
extern "C" int mxtt_opt_sgd_mom(const void* table, const int* first,
                                int n_tensors, long long n_groups,
                                int n_blocks, const float* lr,
                                const float* skip, float momentum,
                                float rescale, float clip, void* stream) {
  return launch(table, first, n_tensors, n_groups, n_blocks, lr, skip,
                Sgd{momentum, rescale, clip}, stream);
}

extern "C" int mxtt_opt_adam(const void* table, const int* first,
                             int n_tensors, long long n_groups, int n_blocks,
                             const float* lr, const float* skip, float beta1,
                             float one_minus_beta1, float beta2,
                             float one_minus_beta2, float epsilon,
                             float rescale, float clip, void* stream) {
  return launch(table, first, n_tensors, n_groups, n_blocks, lr, skip,
                Adam{beta1, one_minus_beta1, beta2, one_minus_beta2, epsilon,
                     rescale, clip},
                stream);
}
