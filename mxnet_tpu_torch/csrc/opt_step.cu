// Fused multi-tensor optimizer steps for Hopper (sm_90a): SGD with momentum
// and Adam, float32.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/opt_step.py: _sgd_mom_body
// (K1, via _kernel_sgd) and _adam_body (K2, via _kernel_adam), both run by
// _run's pallas_call once per parameter. Here ONE launch updates every
// parameter of a step: a device table holds, per tensor, the pointers of
// its weight, gradient and state buffers, its element count, the index of
// its first chunk and its weight decay. Blocks walk the step's chunks with
// a grid-stride loop; each finds its tensor by a binary search over the
// chunk starts. The learning rate is read from a device scalar, so lr
// schedules and Adam's bias correction (folded into lr by the caller) never
// sync the host. A non-null `skip` device flag that is non-zero makes the
// launch leave every buffer untouched (the trainer's non-finite guard).
//
// The update is elementwise and reads each operand once: it is bound by
// device memory (Adam moves 28 bytes per parameter, SGD-momentum 20).
//
// Numerics: bit-exact against the plain PyTorch versions
// (mxnet_tpu_torch/ops/optimizer_op.py) for float32. Every operation is a
// correctly rounded intrinsic in the op order of optimizer_op.py, so the
// global -O3 build (which contracts a*b+c into FMA by default) cannot fuse
// two roundings into one. Scalar constants such as (1 - beta1) are
// computed by the caller in double and rounded once to float, as PyTorch
// rounds a Python scalar. The clip propagates NaN as torch.clamp does.
//
// The launch functions are plain C: each returns cudaGetLastError() after
// its launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;   // elements per chunk
constexpr int kBlocksPerSM = 8;

// One row of the device table; the Python wrapper packs the same 56-byte
// layout (kernels/opt_step.py:_TABLE_DTYPE).
struct TensorDesc {
  float* w;
  const float* g;
  float* s0;          // momentum (SGD) or mean (Adam)
  float* s1;          // variance (Adam); unused by SGD
  long long n;
  long long chunk_begin;
  float wd;
  int pad;
};
static_assert(sizeof(TensorDesc) == 56, "table row layout");

struct SgdHyper {
  float momentum, rescale, clip;
};

struct AdamHyper {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, epsilon, rescale, clip;
};

__device__ __forceinline__ float clip_nan(float g, float c) {
  return g != g ? g : fminf(fmaxf(g, -c), c);
}

__device__ __forceinline__ int find_tensor(const TensorDesc* table, int n,
                                           long long chunk) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].chunk_begin <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// w' = w + m',  m' = momentum*m - lr*(g + wd*w),  g = clip(rescale*grad)
__device__ __forceinline__ void sgd_elem(const TensorDesc& t, long long i,
                                         float lr, const SgdHyper& h) {
  float g = __fmul_rn(t.g[i], h.rescale);
  if (h.clip > 0.f) g = clip_nan(g, h.clip);
  const float w = t.w[i];
  const float m = __fsub_rn(__fmul_rn(h.momentum, t.s0[i]),
                            __fmul_rn(lr, __fadd_rn(g, __fmul_rn(t.wd, w))));
  t.w[i] = __fadd_rn(w, m);
  t.s0[i] = m;
}

// g = clip(rescale*grad + wd*w); mean' = b1*mean + (1-b1)*g;
// var' = b2*var + (1-b2)*g*g; w' = w - (lr*mean') / (sqrt(var') + eps)
__device__ __forceinline__ void adam_elem(const TensorDesc& t, long long i,
                                          float lr, const AdamHyper& h) {
  const float w = t.w[i];
  float g = __fadd_rn(__fmul_rn(t.g[i], h.rescale), __fmul_rn(t.wd, w));
  if (h.clip > 0.f) g = clip_nan(g, h.clip);
  const float mean = __fadd_rn(__fmul_rn(h.beta1, t.s0[i]),
                               __fmul_rn(h.one_minus_beta1, g));
  const float var = __fadd_rn(__fmul_rn(h.beta2, t.s1[i]),
                              __fmul_rn(h.one_minus_beta2, __fmul_rn(g, g)));
  const float step = __fdiv_rn(__fmul_rn(lr, mean),
                               __fadd_rn(__fsqrt_rn(var), h.epsilon));
  t.w[i] = __fsub_rn(w, step);
  t.s0[i] = mean;
  t.s1[i] = var;
}

template <typename Hyper>
__global__ void __launch_bounds__(kThreads)
opt_step_kernel(const TensorDesc* __restrict__ table, int n_tensors,
                long long n_chunks, const float* __restrict__ lr_ptr,
                const float* __restrict__ skip, Hyper h) {
  if (skip != nullptr && *skip != 0.f) return;
  const float lr = *lr_ptr;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const TensorDesc t = table[find_tensor(table, n_tensors, c)];
    const long long start = (c - t.chunk_begin) * kChunk;
    const long long end = start + kChunk < t.n ? start + kChunk : t.n;
#pragma unroll 4
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      if constexpr (std::is_same<Hyper, SgdHyper>::value) sgd_elem(t, i, lr, h);
      else adam_elem(t, i, lr, h);
    }
  }
}

template <typename Hyper>
int launch(const void* table, int n_tensors, long long n_chunks,
           const float* lr, const float* skip, const Hyper& h, void* stream) {
  if (n_tensors < 1 || n_chunks < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)sms * kBlocksPerSM;
  const unsigned blocks = (unsigned)(n_chunks < cap ? n_chunks : cap);
  opt_step_kernel<Hyper><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TensorDesc*>(table), n_tensors, n_chunks, lr, skip, h);
  return (int)cudaGetLastError();
}

}  // namespace

// table: n_tensors TensorDesc rows in device memory, chunk_begin ascending
// from 0, n_chunks = sum of ceil(n / 16384). lr and skip are float32
// device scalars (skip may be null).
extern "C" int mxtt_opt_sgd_mom(const void* table, int n_tensors,
                                long long n_chunks, const float* lr,
                                const float* skip, float momentum,
                                float rescale, float clip, void* stream) {
  return launch(table, n_tensors, n_chunks, lr, skip,
                SgdHyper{momentum, rescale, clip}, stream);
}

extern "C" int mxtt_opt_adam(const void* table, int n_tensors,
                             long long n_chunks, const float* lr,
                             const float* skip, float beta1,
                             float one_minus_beta1, float beta2,
                             float one_minus_beta2, float epsilon,
                             float rescale, float clip, void* stream) {
  return launch(table, n_tensors, n_chunks, lr, skip,
                AdamHyper{beta1, one_minus_beta1, beta2, one_minus_beta2,
                          epsilon, rescale, clip},
                stream);
}
