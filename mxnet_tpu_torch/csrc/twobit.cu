// 2-bit gradient compression with error feedback for Hopper (sm_90a):
// compress (float32 gradient + residual -> int8 codes + new residual) and
// decompress (summed codes -> float32 gradient).
//
// Replaces the TPU kernels of mxnet_tpu/kernels/twobit.py:
// _kernel_compress (K6, body _compress_body) and _kernel_decompress (K7,
// body _decompress_body). The TPU kernels pad the flat tensor to
// (rows, 128) tiles and walk 256-row blocks; here each kernel is one
// grid-stride elementwise pass over the flat tensor with no padding:
// 16-byte loads and stores (four elements per thread and step) when every
// pointer is aligned for them, else one element per step.
//
//   compress:   g = grad + residual
//               code = +1 if g >= thr, -1 if g <= -thr, else 0   (int8)
//               new_residual = g - code * thr
//   decompress: out = float(code) * thr    (code int8 or int32: the sum of
//               the workers' codes decompresses the same way)
//
// Both read and write each element once and do a few operations on it,
// so device memory bounds them: compress moves 13 bytes per element (two
// float32 reads, an int8 and a float32 write), decompress 5 (int8 codes)
// or 8 (int32 codes).
//
// Numerics: bit-exact against the plain PyTorch versions
// (kernels/twobit.py) and the JAX package's _xla_compress /
// _xla_decompress. Every operation is a correctly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fsub_rn, __int2float_rn), so the -O3 build
// cannot contract g - code*thr into one FMA. NaN compares false and gives
// code 0 and a NaN residual, as in the plain versions.
//
// The launch functions are plain C: each returns cudaGetLastError() after
// its launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ int8_t compress1(float grad, float res, float thr,
                                            float neg_thr, float* new_res) {
  const float g = __fadd_rn(grad, res);
  const int8_t code = g >= thr ? 1 : (g <= neg_thr ? -1 : 0);
  *new_res = __fsub_rn(g, __fmul_rn((float)code, thr));
  return code;
}

__global__ void __launch_bounds__(kThreads)
twobit_compress_kernel(const float* __restrict__ grad,
                       const float* __restrict__ res,
                       int8_t* __restrict__ codes,
                       float* __restrict__ new_res, long long n, float thr,
                       int vec) {
  const float neg_thr = -thr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    for (long long j = i; j < n4; j += stride) {
      const float4 g = reinterpret_cast<const float4*>(grad)[j];
      const float4 r = reinterpret_cast<const float4*>(res)[j];
      float4 o;
      char4 c;
      c.x = compress1(g.x, r.x, thr, neg_thr, &o.x);
      c.y = compress1(g.y, r.y, thr, neg_thr, &o.y);
      c.z = compress1(g.z, r.z, thr, neg_thr, &o.z);
      c.w = compress1(g.w, r.w, thr, neg_thr, &o.w);
      reinterpret_cast<char4*>(codes)[j] = c;
      reinterpret_cast<float4*>(new_res)[j] = o;
    }
    done = n4 << 2;
  }
  for (long long j = done + i; j < n; j += stride) {
    float o;
    codes[j] = compress1(grad[j], res[j], thr, neg_thr, &o);
    new_res[j] = o;
  }
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
twobit_decompress_kernel(const C* __restrict__ codes, float* __restrict__ out,
                         long long n, float thr, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    for (long long j = i; j < n4; j += stride) {
      int c0, c1, c2, c3;
      if constexpr (sizeof(C) == 1) {
        const char4 c = reinterpret_cast<const char4*>(codes)[j];
        c0 = c.x; c1 = c.y; c2 = c.z; c3 = c.w;
      } else {
        const int4 c = reinterpret_cast<const int4*>(codes)[j];
        c0 = c.x; c1 = c.y; c2 = c.z; c3 = c.w;
      }
      float4 o;
      o.x = __fmul_rn(__int2float_rn(c0), thr);
      o.y = __fmul_rn(__int2float_rn(c1), thr);
      o.z = __fmul_rn(__int2float_rn(c2), thr);
      o.w = __fmul_rn(__int2float_rn(c3), thr);
      reinterpret_cast<float4*>(out)[j] = o;
    }
    done = n4 << 2;
  }
  for (long long j = done + i; j < n; j += stride)
    out[j] = __fmul_rn(__int2float_rn((int)codes[j]), thr);
}

int grid_for(long long n, int vec) {
  const long long work = vec ? (n >> 2) + 3 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// vec: non-zero when grad, residual and new_residual are 16-byte aligned
// and codes 4-byte aligned (the wrapper checks).
extern "C" int mxtt_twobit_compress(const float* grad, const float* residual,
                                    int8_t* codes, float* new_residual,
                                    long long n, float thr, int vec,
                                    void* stream) {
  twobit_compress_kernel<<<grid_for(n, vec), kThreads, 0,
                           (cudaStream_t)stream>>>(grad, residual, codes,
                                                   new_residual, n, thr, vec);
  return (int)cudaGetLastError();
}

// code_bytes: 1 (int8 codes) or 4 (int32 codes). vec: non-zero when out is
// 16-byte aligned and codes aligned to four codes.
extern "C" int mxtt_twobit_decompress(const void* codes, int code_bytes,
                                      float* out, long long n, float thr,
                                      int vec, void* stream) {
  const int grid = grid_for(n, vec);
  if (code_bytes == 1) {
    twobit_decompress_kernel<int8_t><<<grid, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const int8_t*)codes, out, n, thr, vec);
  } else if (code_bytes == 4) {
    twobit_decompress_kernel<int32_t><<<grid, kThreads, 0,
                                        (cudaStream_t)stream>>>(
        (const int32_t*)codes, out, n, thr, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
