// int8 GEMM with the dequantize, bias and relu epilogue, for Hopper (sm_90a),
// on the int8 tensor cores.
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
// What bounds it: at M = 4096 the float32 output write (4 bytes an output
// against 2 * K operations) and the operations at the int8 tensor cores'
// 1,979 TOP/s are of one order, 5-17 microseconds a product. The products
// run on the tensor cores with mma.sync m16n8k32 (s8 x s8 -> s32, no
// .satfinite: the int32 sum wraps as XLA's would, and with |x|, |w| <= 128
// and K < 2^17 it cannot overflow); mma.sync reaches only part of the
// peak that wgmma has, so the operations bound it first.
//
// Design: a block of 8 warps owns a 128 x 128 or 128 x 64 output tile
// (kBM x BN; the launch picks by the grid's size, pick_tile) and walks K in
// steps of 64 bytes. Warps split the tile 2 x 4 (warp tile 64 x 32) or
// 4 x 2 (32 x 32); each holds its sums as int32 fragments in registers.
// Operand tiles pass through a ring of kStages stages in dynamic shared
// memory, rows of 64 bytes whose four 16-byte chunks are XOR-swizzled by
// row (swz) so that ldmatrix and the 16-byte stores are free of bank
// conflicts. ldmatrix.x4 reads an A fragment (16 rows x 32 k bytes) or
// the B fragments of two n8 tiles; x is the row operand and w, stored
// (N, K), the col operand, so neither is transposed.
//
// Two ways of filling the stages, one core:
// * the cp.async path (K % 16 == 0 and both operands 16-byte aligned, as
//   every product of the served encoder): cp.async.cg, 16 bytes a thread,
//   kStages - 1 stages in flight, so the copies of stage s + 3 overlap the
//   products of stage s; rows and k bytes past the edge are zero-filled by
//   the copy's src-size operand (a zero adds exactly 0);
// * the staged path (any other K or alignment): each thread reads its 16
//   bytes one at a time, zero past the edge, and stores them to the same
//   swizzled layout. Synchronous and slow; correct for any input.
//
// Epilogue, unchanged from the first version: each int32 goes through
// __int2float_rn (round to nearest even, as XLA's convert; |acc| may pass
// 2^24), __fmul_rn by its column's scale, __fadd_rn of the bias, then relu
// as `v < 0 ? 0 : v` (NaN passes, as torch.clamp_min and jnp.maximum):
// correctly rounded intrinsics, so the -O3 build cannot contract the
// multiply and add into an FMA. Bit-exact against the plain version
// (kernels/int8_gemm.py) and the JAX op. A thread loads its columns'
// scales and biases once and writes its two adjacent columns per row as
// one float2 (scalar stores where N is odd).
//
// What is left: wgmma with TMA (the full tensor-core rate), a persistent
// grid over output tiles so one tile's epilogue overlaps the next one's
// loads, and the activation quantize fused into the A-tile load.
//
// The launch functions are plain C: they return cudaGetLastError() after
// the launch and never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBM = 128;        // output rows per block
constexpr int kBK = 64;         // k bytes per stage
constexpr int kChunks = kBK / 16;   // 16-byte chunks in a tile row
constexpr int kStages = 4;      // ring of shared-memory stages
constexpr int kThreads = 256;   // 8 warps
constexpr int kWN = 32;         // warp tile columns: 4 n8 tiles
constexpr int kNI = kWN / 8;
constexpr int kMaxDevices = 64;

template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN / kWN;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;   // warp tile rows
  static constexpr int kMI = kWM / 16;        // m16 tiles per warp
  static constexpr int kStageBytes = (kBM + BN) * kBK;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

// Byte offset of 16-byte chunk `chunk` of tile row `row`: rows of kBK
// bytes, chunks XOR-swizzled by row ((row / 2) % 4 for 4 chunks a row), so
// the 8 consecutive rows that one ldmatrix phase reads at one chunk, and
// the 128 bytes that 8 threads' 16-byte stores write, hit 8 distinct
// 16-byte bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  constexpr int kShift = kChunks == 4 ? 1 : 0;
  return row * kBK + ((chunk ^ ((row >> kShift) & (kChunks - 1))) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fill one stage's tile of `kRows` rows x kBK k bytes from a row-major
// int8 matrix of `rows` rows and K columns, rows [row0, row0 + kRows),
// bytes [k0, k0 + kBK); zero outside the matrix. Thread t writes chunks
// t, t + 256, ...: chunk id -> row id / kChunks, chunk id % kChunks.
template <int kRows, bool kAsync>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const int8_t* __restrict__ src,
                                          int rows, int row0, int K, int k0) {
  constexpr int kPerThread = kRows * kChunks / kThreads;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int id = threadIdx.x + i * kThreads;
    const int r = id / kChunks;
    const int c = id % kChunks;
    const int gr = row0 + r;
    const int gk = k0 + c * 16;
    const uint32_t d = dst + swz(r, c);
    if (kAsync) {
      // K % 16 == 0: a chunk is wholly inside or wholly past the edge
      const bool in = gr < rows && gk < K;
      cp_async16(d, in ? src + (size_t)gr * K + gk : src, in ? 16 : 0);
    } else {
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
        const int8_t* p = src + (size_t)gr * K;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (gk + b < K) word[b >> 2] |= (uint32_t)(uint8_t)p[gk + b]
                                          << (8 * (b & 3));
      }
      asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(d),
                   "r"(word[0]), "r"(word[1]), "r"(word[2]), "r"(word[3])
                   : "memory");
    }
  }
}

__device__ __forceinline__ float epilogue(int acc, float scale, float bias,
                                          bool has_bias, int relu) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (has_bias) v = __fadd_rn(v, bias);
  if (relu && v < 0.f) v = 0.f;
  return v;
}

// Two blocks of 128 x 128 (at most 128 registers a thread) or three of
// 128 x 64 (85) share an SM.
template <int BN, bool kAsync>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 2 : 3)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, int scale_stride,
                 const float* __restrict__ bias, int relu,
                 float* __restrict__ out, int M, int N, int K) {
  using T = Tile<BN>;
  constexpr int kMI = T::kMI;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / T::kWarpsN) * T::kWM;   // warp tile's first row
  const int wn = (warp % T::kWarpsN) * kWN;      // and column in the block
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int k_tiles = (K + kBK - 1) / kBK;

  auto load_stage = [&](int kt) {
    const uint32_t a = base + (kt % kStages) * T::kStageBytes;
    load_tile<kBM, kAsync>(a, x, M, m0, K, kt * kBK);
    load_tile<BN, kAsync>(a + kBM * kBK, w, N, n0, K, kt * kBK);
  };

  int acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    // stage kt has landed (this thread's copies), then every thread's
    // copies are visible and every thread is done with stage kt - 1,
    // whose slot the next load reuses
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < k_tiles) load_stage(kt + kStages - 1);
    cp_async_commit();
    const uint32_t a_s = base + (kt % kStages) * T::kStageBytes;
    const uint32_t b_s = a_s + kBM * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      // A: lanes 0-15 give rows 0-15 of k bytes [0, 16), lanes 16-31 the
      // same rows of [16, 32): registers a0-a3 as the m16n8k32 row operand
      uint32_t a[kMI][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
        ldmatrix_x4(a[i], a_s + swz(wm + 16 * i + (lane & 15),
                                    2 * kk + (lane >> 4)));
      // B: lanes 8q..8q+7 give n rows (q / 2) * 8 + 0..7 of k bytes
      // [16 (q % 2), +16): b0, b1 of n8 tile 2p, then of tile 2p + 1
      uint32_t b[kNI][2];
#pragma unroll
      for (int p = 0; p < kNI / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + swz(wn + 16 * p + (lane & 7) + ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // the m16n8 sum layout: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at
  // row g + 8
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool has_bias = bias != nullptr;
  float sc[kNI][2], bi[kNI][2];
#pragma unroll
  for (int j = 0; j < kNI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + 8 * j + 2 * t + e;
      sc[j][e] = n < N ? scale[n * scale_stride] : 0.f;
      bi[j][e] = has_bias && n < N ? bias[n] : 0.f;
    }
  const bool pairs = (N & 1) == 0;   // then out + m * N + n is 8-byte aligned
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      float* row = out + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n >= N) continue;
        const float v0 = epilogue(acc[i][j][2 * h], sc[j][0], bi[j][0],
                                  has_bias, relu);
        const float v1 = epilogue(acc[i][j][2 * h + 1], sc[j][1], bi[j][1],
                                  has_bias, relu);
        if (pairs) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          row[n] = v0;
          if (n + 1 < N) row[n + 1] = v1;
        }
      }
    }
}

cudaError_t current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  return *dev < 0 || *dev >= kMaxDevices ? cudaErrorInvalidDevice
                                         : cudaSuccess;
}

// Lift the 48 KB default limit on dynamic shared memory, once per device
// and kernel.
template <int BN, bool kAsync>
cudaError_t allow_smem(int dev) {
  static std::atomic<bool> done[kMaxDevices];
  if (done[dev].load()) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      int8_gemm_kernel<BN, kAsync>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmemBytes);
  if (e == cudaSuccess) done[dev].store(true);
  return e;
}

// The device's streaming multiprocessors, read once per device.
cudaError_t sm_count(int dev, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  *sms = known[dev].load();
  if (*sms > 0) return cudaSuccess;
  const cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) known[dev].store(*sms);
  return e;
}

// 128 x 128 tiles where the grid still gives every SM two blocks to run,
// else 128 x 64 (twice the blocks for the same product). On an H100 (132
// SMs) that is 128 x 128 at (4096, 768, 3072) and 128 x 64 where N = 768,
// the faster width at each (PERF.md).
int pick_tile(int M, int N, int sms) {
  const long long blocks = (long long)((M + kBM - 1) / kBM) * ((N + 127) / 128);
  return blocks >= 2LL * sms ? 128 : 64;
}

template <int BN, bool kAsync>
int launch(int dev, const int8_t* x, const int8_t* w, const float* scale,
           int scale_stride, const float* bias, int relu, float* out, int M,
           int N, int K, cudaStream_t s) {
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<BN, kAsync>(dev);
  if (e != cudaSuccess) return (int)e;
  int8_gemm_kernel<BN, kAsync><<<grid, kThreads, Tile<BN>::kSmemBytes, s>>>(
      x, w, scale, scale_stride, bias, relu, out, M, N, K);
  return (int)cudaGetLastError();
}

template <int BN>
int blocks_per_sm() {
  int dev = 0, blocks = 0;
  cudaError_t e = current_device(&dev);
  if (e == cudaSuccess) e = allow_smem<BN, true>(dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, int8_gemm_kernel<BN, true>, kThreads, Tile<BN>::kSmemBytes);
  return e == cudaSuccess ? blocks : -1;
}

bool use_async(const void* x, const void* w, int K) {
  return K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace

// The output tile's width (64 or 128) that mxtt_int8_gemm uses for M x N
// on the current device, or -1 on an error.
extern "C" int mxtt_int8_gemm_pick_tile(int M, int N) {
  int dev = 0, sms = 0;
  if (current_device(&dev) != cudaSuccess || sm_count(dev, &sms) != cudaSuccess)
    return -1;
  return pick_tile(M, N, sms);
}

// Blocks of the cp.async kernel with a tile of 128 x tile_n (64 or 128)
// that fit on one SM at once, or -1 on an error.
extern "C" int mxtt_int8_gemm_blocks_per_sm(int tile_n) {
  if (tile_n == 128) return blocks_per_sm<128>();
  if (tile_n == 64) return blocks_per_sm<64>();
  return -1;
}

// x: int8 (M, K), w: int8 (N, K), out: float32 (M, N), all row-major and
// dense on the current device; scale: float32, read at n * scale_stride;
// bias: float32 (N,) or null. M, N >= 1, K >= 0. tile_n: 64 or 128, the
// output tile's width, or 0 for pick_tile's. *async_path (when not null)
// is set to 1 for the cp.async path, 0 for the staged one.
extern "C" int mxtt_int8_gemm_tile(const void* x, const void* w,
                                   const float* scale, int scale_stride,
                                   const float* bias, int relu, float* out,
                                   int M, int N, int K, int tile_n,
                                   void* stream, int* async_path) {
  if (M < 1 || N < 1 || K < 0 || (scale_stride != 0 && scale_stride != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return (int)e;
  if (tile_n == 0) {
    int sms = 0;
    e = sm_count(dev, &sms);
    if (e != cudaSuccess) return (int)e;
    tile_n = pick_tile(M, N, sms);
  }
  if (tile_n != 64 && tile_n != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const bool fast = use_async(x, w, K);
  if (async_path) *async_path = fast ? 1 : 0;
  if (tile_n == 128)
    return fast ? launch<128, true>(dev, xp, wp, scale, scale_stride, bias,
                                    relu, out, M, N, K, s)
                : launch<128, false>(dev, xp, wp, scale, scale_stride, bias,
                                     relu, out, M, N, K, s);
  return fast ? launch<64, true>(dev, xp, wp, scale, scale_stride, bias, relu,
                                 out, M, N, K, s)
              : launch<64, false>(dev, xp, wp, scale, scale_stride, bias,
                                  relu, out, M, N, K, s);
}

// The entry point with PR 3's signature: the tile by pick_tile.
extern "C" int mxtt_int8_gemm(const void* x, const void* w, const float* scale,
                              int scale_stride, const float* bias, int relu,
                              float* out, int M, int N, int K, void* stream) {
  return mxtt_int8_gemm_tile(x, w, scale, scale_stride, bias, relu, out, M, N,
                             K, 0, stream, nullptr);
}
