// 2-bit gradient compression with error feedback for Hopper (sm_90a):
// compress (gradient + residual -> int8 codes + new residual) and
// decompress (summed codes -> gradient). The multi-tensor compress takes
// float32; the single-tensor compress and the decompress also float16 and
// bfloat16, as the reference's store compresses a half-precision key and
// its decompress writes any float dtype.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/twobit.py:
// _kernel_compress (K6, body _compress_body) and _kernel_decompress (K7,
// body _decompress_body), which the JAX package's kvstore runs once per
// parameter. The TPU kernels pad the flat tensor to (rows, 128) tiles and
// walk 256-row blocks. Here:
//
// * Compress. The multi-tensor kernel, on the dist kvstore's bucketed
//   path: ONE launch per push call covers every listed gradient. A device
//   table holds one row per gradient (its pointer, its residual and code
//   slots in the store's flat buffers, its size), and each gradient's codes
//   go straight into its slot of the int8 wire buffer that the all-reduce
//   sends, its residual updated in place. The single-tensor kernel (a
//   grid-stride loop, four elements a thread) serves the per-key path.
// * Decompress. int8 codes (one worker's, or the int8 sum of the workers'
//   codes: on the bucketed path a contiguous run of reduced wire slices,
//   ONE launch per pull call) take the tiled kernel below; int32 codes a
//   grid-stride loop, four codes a thread.
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
// or 8 (int32 codes). The multi-tensor compress and the int8 decompress
// keep the memory system full, in the style of opt_step.cu:
//
// * 16 elements a thread, every access coalesced: a warp takes 512
//   contiguous elements of one tensor (a group), and each thread four
//   16-byte loads of the gradient and four of the residual, four 16-byte
//   stores of the residual and ONE 16-byte store of codes (decompress: one
//   16-byte load of codes, four float4 stores). Lane l moves float4
//   number 32u + l of the group, so every warp instruction covers 512
//   contiguous bytes; the codes pass through a 512-byte stage per warp in
//   shared memory, so that lane l's one 16-byte access holds codes
//   16l..16l+15. (A first version gave each thread 16 contiguous
//   elements: its float4s lay 64 bytes apart across the warp, and the
//   decompress ran at half the rate of a grid-stride loop.) The
//   store's slots start at multiples of 16 elements, so residual and
//   codes are always 16-byte aligned; a gradient that is not (a row's vec
//   flag is 0) and a tensor's last, partial group take a loop of one
//   element a lane in the same launch.
// * An even split. The call's elements are numbered as one flat sequence
//   of 512-element groups (each gradient starts a new group) and cut into
//   tiles of 8 groups (4096 elements, one per warp of a block). One wave
//   of blocks (occupancy x SMs, asked once per device) deals the tiles
//   round-robin. For the compress the wrapper builds, with the table, the
//   row each tile starts in; a warp walks on from there to the row of its
//   own group (a tile spans few rows).
//
// Numerics: bit-exact against the plain PyTorch versions
// (kernels/twobit.py) and the JAX package's _xla_compress /
// _xla_decompress. Every operation is a correctly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fsub_rn, __int2float_rn), so the -O3 build
// cannot contract g - code*thr into one FMA. In float16 and bfloat16 each
// operation runs in float32 and is rounded to the type at once
// (__float2half_rn, __float2bfloat16_rn), which is the type's correctly
// rounded result; the wrapper hands over the threshold rounded to float32
// and then to the type, as the JAX store's XLA path rounds a weak-typed
// Python float.
// A 16-byte vector holds 8 halves, so the half-precision paths move 8
// elements per 16-byte access where float32 moves 4. NaN compares false
// and gives code 0 and a NaN residual, as in the plain versions.
//
// The launch functions are plain C: each returns cudaGetLastError() after
// its launch and never synchronises.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

// The gradient's (or the output's) element type: float, __half or
// __nv_bfloat16. Arithmetic runs in float32 with each +, - and * rounded
// back to the element type at once, so a half-precision result is the
// correctly rounded one of that type (float32 carries more than 2p + 2
// bits of a half's or a bfloat16's p), as the plain versions compute it.
template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Elem<__half> {
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half round(float x) {
    return __float2half_rn(x);
  }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 round(float x) {
    return __float2bfloat16_rn(x);
  }
};

// thr: the threshold already rounded to T (exact in float32).
template <typename T>
__device__ __forceinline__ int8_t compress1(T grad, T res, float thr,
                                            float neg_thr, T* new_res) {
  const float g = Elem<T>::load(
      Elem<T>::round(__fadd_rn(Elem<T>::load(grad), Elem<T>::load(res))));
  const int8_t code = g >= thr ? 1 : (g <= neg_thr ? -1 : 0);
  *new_res = Elem<T>::round(__fsub_rn(g, __fmul_rn((float)code, thr)));
  return code;
}

// code (an int8 or int32 sum of codes) x thr in T: the code rounded to T
// first, as codes.astype(dtype) * thr.
template <typename T>
__device__ __forceinline__ T decompress1(int code, float thr) {
  return Elem<T>::round(__fmul_rn(
      Elem<T>::load(Elem<T>::round(__int2float_rn(code))), thr));
}

__device__ __forceinline__ int pack4(const int8_t* c) {
  return (int)(uint8_t)c[0] | ((int)(uint8_t)c[1] << 8) |
         ((int)(uint8_t)c[2] << 16) | ((int)(uint8_t)c[3] << 24);
}

// V codes (4 or 8) with one 4- or 8-byte store.
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const int8_t* c) {
  if constexpr (V == 4) {
    *reinterpret_cast<int*>(p) = pack4(c);
  } else {
    *reinterpret_cast<int2*>(p) = make_int2(pack4(c), pack4(c + 4));
  }
}

// The single-tensor compress (the per-key path): a grid-stride loop over
// 16-byte vectors of V = 16 / sizeof(T) elements (4 float32 or 8 halves),
// the codes of a vector stored with one V-byte store.
template <typename T>
__global__ void __launch_bounds__(kThreads)
twobit_compress_kernel(const T* __restrict__ grad, const T* __restrict__ res,
                       int8_t* __restrict__ codes, T* __restrict__ new_res,
                       long long n, float thr, int vec) {
  constexpr int V = 16 / sizeof(T);
  const float neg_thr = -thr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long j = i; j < nv; j += stride) {
      const uint4 gv = reinterpret_cast<const uint4*>(grad)[j];
      const uint4 rv = reinterpret_cast<const uint4*>(res)[j];
      const T* g = reinterpret_cast<const T*>(&gv);
      const T* r = reinterpret_cast<const T*>(&rv);
      uint4 ov;
      T* o = reinterpret_cast<T*>(&ov);
      int8_t c[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        c[k] = compress1<T>(g[k], r[k], thr, neg_thr, &o[k]);
      store_codes<V>(codes + j * V, c);
      reinterpret_cast<uint4*>(new_res)[j] = ov;
    }
    done = nv * V;
  }
  for (long long j = done + i; j < n; j += stride) {
    T o;
    codes[j] = compress1<T>(grad[j], res[j], thr, neg_thr, &o);
    new_res[j] = o;
  }
}

template <int Bytes> struct Raw;
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// int32 codes (the sum of many workers' codes), four a thread: one
// 16-byte load of codes, one store of four T (16 or 8 bytes).
template <typename T>
__global__ void __launch_bounds__(kThreads)
twobit_decompress_i32_kernel(const int* __restrict__ codes,
                             T* __restrict__ out, long long n, float thr,
                             int vec) {
  using R = typename Raw<4 * sizeof(T)>::type;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    for (long long j = i; j < n4; j += stride) {
      const int4 c = reinterpret_cast<const int4*>(codes)[j];
      R ov;
      T* o = reinterpret_cast<T*>(&ov);
      o[0] = decompress1<T>(c.x, thr);
      o[1] = decompress1<T>(c.y, thr);
      o[2] = decompress1<T>(c.z, thr);
      o[3] = decompress1<T>(c.w, thr);
      reinterpret_cast<R*>(out)[j] = ov;
    }
    done = n4 << 2;
  }
  for (long long j = done + i; j < n; j += stride)
    out[j] = decompress1<T>(codes[j], thr);
}

// ---- the tiled kernels -----------------------------------------------------

constexpr int kWarpElems = 512;        // elements a warp handles per tile
constexpr int kWarps = kThreads / 32;
constexpr int kTileGroups = kWarps;    // as TILE_GROUPS in kernels/twobit.py

// One row of the compress table; the Python wrapper packs the same 48-byte
// layout (kernels/twobit.py:_ROW_DTYPE).
struct CompressRow {
  const float* grad;
  float* res;          // the key's residual slot, updated in place
  int8_t* codes;       // the key's wire slot
  long long n;         // elements
  long long begin;     // its first group in the call's flat group sequence
  int vec;             // 1: grad, res and codes all 16-byte aligned
  int pad;
};
static_assert(sizeof(CompressRow) == 48, "table row layout");

__device__ __forceinline__ int compress_word(const float4& g, float4& r,
                                             float thr, float neg_thr) {
  int8_t c[4];
  c[0] = compress1<float>(g.x, r.x, thr, neg_thr, &r.x);
  c[1] = compress1<float>(g.y, r.y, thr, neg_thr, &r.y);
  c[2] = compress1<float>(g.z, r.z, thr, neg_thr, &r.z);
  c[3] = compress1<float>(g.w, r.w, thr, neg_thr, &r.w);
  return pack4(c);
}

// A group is kWarpElems elements of one tensor, handled by one warp: lane
// l loads float4 number 32u + l (u = 0..3) of the group's gradient and
// residual, so each load and store instruction of the warp covers 512
// contiguous bytes. Its 16 codes go to the warp's 512-byte stage in shared
// memory, in element order, from which lane l stores codes 16l..16l+15
// with one 16-byte store. Tile t holds groups [t * kTileGroups, (t + 1) *
// kTileGroups) of the call: block b takes tiles b, b + B, ..., warp w
// group t * kTileGroups + w. first[t] is the row holding the tile's first
// group; a warp walks on from there to its own.
__global__ void __launch_bounds__(kThreads)
twobit_compress_multi_kernel(const CompressRow* __restrict__ table,
                             const int* __restrict__ first,
                             long long n_groups, float thr) {
  __shared__ int4 stage[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* words = reinterpret_cast<int*>(stage[warp]);
  const float neg_thr = -thr;
  const long long n_tiles = (n_groups + kTileGroups - 1) / kTileGroups;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long grp = tile * kTileGroups + warp;
    if (grp >= n_groups) break;   // the same for the whole warp
    int k = first[tile];
    CompressRow t = table[k];
    while (grp >= t.begin + (t.n + kWarpElems - 1) / kWarpElems)
      t = table[++k];
    const long long e0 = (grp - t.begin) * kWarpElems;
    if (t.vec && e0 + kWarpElems <= t.n) {
      const float4* __restrict__ gp =
          reinterpret_cast<const float4*>(t.grad + e0);
      float4* __restrict__ rp = reinterpret_cast<float4*>(t.res + e0);
      float4 g[4], r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        g[u] = __ldcs(gp + 32 * u + lane);
        r[u] = rp[32 * u + lane];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        words[32 * u + lane] = compress_word(g[u], r[u], thr, neg_thr);
        __stcs(rp + 32 * u + lane, r[u]);
      }
      __syncwarp();
      __stcs(reinterpret_cast<int4*>(t.codes + e0) + lane, stage[warp][lane]);
      __syncwarp();   // the stage is read before the next group writes it
    } else {
      const long long e1 = e0 + kWarpElems < t.n ? e0 + kWarpElems : t.n;
      for (long long e = e0 + lane; e < e1; e += 32) {
        float o;
        t.codes[e] = compress1<float>(t.grad[e], t.res[e], thr, neg_thr, &o);
        t.res[e] = o;
      }
    }
  }
}

// n int8 codes into T, the same groups and tiles with no table: lane l
// loads codes 16l..16l+15 of its warp's group with one 16-byte load into
// the stage, then stores 16-byte vector number 32u + l of the group's
// output (V = 16 / sizeof(T) elements: u = 0..3 for float32, 0..1 for
// halves) from the V codes at stage byte (32u + l) * V. vec: codes and
// out both 16-byte aligned; else, and for a ragged last group, one code a
// lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
twobit_decompress_kernel(const int8_t* __restrict__ codes,
                         T* __restrict__ out, long long n, float thr,
                         int vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kStores = kWarpElems / (32 * V);
  __shared__ int4 stage[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* words = reinterpret_cast<const int*>(stage[warp]);
  const long long n_groups = (n + kWarpElems - 1) / kWarpElems;
  const long long stride = (long long)gridDim.x * kTileGroups;
  for (long long grp = (long long)blockIdx.x * kTileGroups + warp;
       grp < n_groups; grp += stride) {
    const long long e0 = grp * kWarpElems;
    if (vec && e0 + kWarpElems <= n) {
      stage[warp][lane] =
          __ldcs(reinterpret_cast<const int4*>(codes + e0) + lane);
      __syncwarp();
      uint4* __restrict__ op = reinterpret_cast<uint4*>(out + e0);
#pragma unroll
      for (int u = 0; u < kStores; ++u) {
        const int* w = words + (32 * u + lane) * (V / 4);
        uint4 ov;
        T* o = reinterpret_cast<T*>(&ov);
#pragma unroll
        for (int k = 0; k < V; ++k)
          o[k] = decompress1<T>((int)(int8_t)((w[k >> 2] >> (8 * (k & 3))) &
                                              0xff), thr);
        __stcs(op + 32 * u + lane, ov);
      }
      __syncwarp();   // the stage is read before the next group writes it
    } else {
      const long long e1 = e0 + kWarpElems < n ? e0 + kWarpElems : n;
      for (long long e = e0 + lane; e < e1; e += 32)
        out[e] = decompress1<T>((int)codes[e], thr);
    }
  }
}

int grid_for(long long n, int vec) {
  const long long work = vec ? (n >> 2) + 3 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16 (the gradient's, residual's
// and new residual's); thr: the threshold rounded to that dtype. vec:
// non-zero when grad, residual and new_residual are 16-byte aligned and
// codes aligned to 16 / sizeof(element) bytes (the wrapper checks).
extern "C" int mxtt_twobit_compress(const void* grad, const void* residual,
                                    int8_t* codes, void* new_residual,
                                    int dtype, long long n, float thr,
                                    int vec, void* stream) {
  const int grid = grid_for(n, vec);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    twobit_compress_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)grad, (const float*)residual, codes,
        (float*)new_residual, n, thr, vec);
  } else if (dtype == 1) {
    twobit_compress_kernel<__half><<<grid, kThreads, 0, s>>>(
        (const __half*)grad, (const __half*)residual, codes,
        (__half*)new_residual, n, thr, vec);
  } else if (dtype == 2) {
    twobit_compress_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)grad, (const __nv_bfloat16*)residual, codes,
        (__nv_bfloat16*)new_residual, n, thr, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

namespace {

template <typename T>
int decompress_as(const void* codes, int code_bytes, void* out, long long n,
                  float thr, int vec, int n_blocks, cudaStream_t s) {
  if (code_bytes == 1) {
    if (n_blocks < 1) return (int)cudaErrorInvalidValue;
    twobit_decompress_kernel<T><<<n_blocks, kThreads, 0, s>>>(
        (const int8_t*)codes, (T*)out, n, thr, vec);
  } else if (code_bytes == 4) {
    twobit_decompress_i32_kernel<T><<<grid_for(n, vec), kThreads, 0, s>>>(
        (const int*)codes, (T*)out, n, thr, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// code_bytes: 1 (int8 codes) or 4 (int32 codes). dtype: the output's, 0
// float32, 1 float16, 2 bfloat16; thr rounded to it. vec: non-zero when
// codes and out are 16-byte aligned. n_blocks: the int8 kernel's blocks,
// at most one full wave (mxtt_twobit_wave); the int32 loop sizes its own
// grid.
extern "C" int mxtt_twobit_decompress(const void* codes, int code_bytes,
                                      void* out, int dtype, long long n,
                                      float thr, int vec, int n_blocks,
                                      void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return decompress_as<float>(codes, code_bytes, out, n, thr, vec,
                                  n_blocks, s);
    case 1:
      return decompress_as<__half>(codes, code_bytes, out, n, thr, vec,
                                   n_blocks, s);
    case 2:
      return decompress_as<__nv_bfloat16>(codes, code_bytes, out, n, thr,
                                          vec, n_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of one full wave on the current device of the multi-tensor
// compress (which 0) or the int8 decompress (which 1): the wrapper asks
// once per device.
extern "C" int mxtt_twobit_wave(int which, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = which ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, twobit_decompress_kernel<float>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, twobit_compress_multi_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// table: n_rows CompressRow entries in device memory, begin ascending from
// 0 by ceil(n / 512); n_groups = sum of ceil(n / 512); first: one int per
// tile of kTileGroups groups in device memory, first[t] the row holding
// group t * kTileGroups; n_blocks: at most one full wave
// (mxtt_twobit_wave).
extern "C" int mxtt_twobit_compress_multi(const void* table, const int* first,
                                          int n_rows, long long n_groups,
                                          int n_blocks, float thr,
                                          void* stream) {
  if (n_rows < 1 || n_blocks < 1 || n_groups < 1)
    return (int)cudaErrorInvalidValue;
  twobit_compress_multi_kernel<<<n_blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      static_cast<const CompressRow*>(table), first, n_groups, thr);
  return (int)cudaGetLastError();
}
