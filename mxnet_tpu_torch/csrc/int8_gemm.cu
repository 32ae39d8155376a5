// int8 GEMM with the dequantize, bias and relu epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/kernels/int8_gemm.py: _gemm_body,
// launched by _kernel's pallas_call (K4). It computes
//
//   out[m, n] = relu?( float(sum_k x[m, k] * w[n, k]) * scale[n] + bias[n] )
//
// for int8 x (M, K) and w (N, K), both row-major, with exact int32
// accumulation; scale is float32, one value (scale_stride 0) or one per
// output channel (scale_stride 1); bias is float32 (N,) or null; the output
// is float32 (M, N). Every quantized FullyConnected of the port comes here
// (ops/quantization.py), so in a served int8 encoder the shapes are
// M = tokens of the batch, (K, N) = (768, 768), (768, 3072), (3072, 768).
//
// What bounds it: at those shapes the operations (2*M*N*K at the tensor
// cores' 1,979 TOP/s) and the float32 output write are of one order, a few
// to tens of microseconds. This first version does not reach that: it
// runs on the CUDA cores with __dp4a (four int8 products summed into an
// int32 per instruction), not on the int8 tensor cores (mma.sync m16n8k32,
// then wgmma with TMA), which are later work.
//
// Design: each block owns a 64 x 64 output tile and walks K in steps of 64
// bytes. Both operand tiles are staged in shared memory as 32-bit words of
// four consecutive k bytes (rows padded to 17 words against bank
// conflicts); each of the 256 threads keeps a 4 x 4 int32 accumulator in
// registers, for rows ty + 16 i and columns tx + 16 j. Ragged M, N and K
// are zero-filled in the tiles (a zero contributes exactly 0) and masked
// at the store. With K a multiple of 16 and 16-byte aligned operands the
// tiles are loaded 16 bytes a thread; otherwise byte by byte.
//
// Numerics: bit-exact against the plain version (kernels/int8_gemm.py) and
// the JAX op. The int32 sum is exact in any order; the epilogue is
// __int2float_rn (round to nearest even, as XLA's convert; |acc| may pass
// 2^24), then __fmul_rn by the scale, then __fadd_rn of the bias, then
// relu as `v < 0 ? 0 : v` (NaN passes, as torch.clamp_min and
// jnp.maximum): correctly rounded intrinsics, so the -O3 build cannot
// contract the multiply and add into an FMA.
//
// The launch function is plain C: it returns cudaGetLastError() after the
// launch and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;             // output rows per block
constexpr int kBN = 64;             // output columns per block
constexpr int kBK = 64;             // k bytes per tile
constexpr int kWords = kBK / 4;     // 32-bit words of k per tile row
constexpr int kPad = kWords + 1;    // padded row of a shared tile
constexpr int kThreads = 256;

// Stage rows [row0, row0 + 64) x bytes [k0, k0 + 64) of a row-major int8
// matrix of `rows` rows and K columns into dst, zero outside the matrix.
// Thread t loads 16 bytes: row t / 4, bytes 16 * (t % 4) of the tile.
template <bool kVec>
__device__ __forceinline__ void load_tile(int32_t (*dst)[kPad],
                                          const int8_t* __restrict__ src,
                                          int rows, int row0, int K, int k0) {
  const int r = threadIdx.x >> 2;
  const int c = (threadIdx.x & 3) * 16;
  const int gr = row0 + r;
  const int gk = k0 + c;
  int32_t word[4] = {0, 0, 0, 0};
  if (gr < rows) {
    const int8_t* p = src + (size_t)gr * K + gk;
    if (kVec) {
      if (gk < K) {
        const int4 v = *reinterpret_cast<const int4*>(p);
        word[0] = v.x;
        word[1] = v.y;
        word[2] = v.z;
        word[3] = v.w;
      }
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const uint32_t byte = gk + b < K ? (uint32_t)(uint8_t)p[b] : 0u;
        word[b >> 2] |= (int32_t)(byte << (8 * (b & 3)));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[r][(c >> 2) + i] = word[i];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, int scale_stride,
                 const float* __restrict__ bias, int relu,
                 float* __restrict__ out, int M, int N, int K) {
  __shared__ int32_t xs[kBM][kPad];
  __shared__ int32_t ws[kBN][kPad];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile<kVec>(xs, x, M, m0, K, k0);
    load_tile<kVec>(ws, w, N, n0, K, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = __fmul_rn(__int2float_rn(acc[i][j]), scale[n * scale_stride]);
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      if (relu && v < 0.f) v = 0.f;
      out[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace

// x: int8 (M, K), w: int8 (N, K), out: float32 (M, N), all row-major and
// dense on the current device; scale: float32, read at n * scale_stride;
// bias: float32 (N,) or null. M, N >= 1, K >= 0.
extern "C" int mxtt_int8_gemm(const void* x, const void* w, const float* scale,
                              int scale_stride, const float* bias, int relu,
                              float* out, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 0 || (scale_stride != 0 && scale_stride != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  if (vec)
    int8_gemm_kernel<true><<<grid, kThreads, 0, s>>>(
        xp, wp, scale, scale_stride, bias, relu, out, M, N, K);
  else
    int8_gemm_kernel<false><<<grid, kThreads, 0, s>>>(
        xp, wp, scale, scale_stride, bias, relu, out, M, N, K);
  return (int)cudaGetLastError();
}
