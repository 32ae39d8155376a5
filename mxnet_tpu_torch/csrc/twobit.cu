// 2-bit gradient compression with error feedback for Hopper (sm_90a):
// compress (float32 gradient + residual -> int8 codes + new residual) and
// decompress (summed codes -> float32 gradient).
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

// int32 codes (the sum of many workers' codes), four a thread.
__global__ void __launch_bounds__(kThreads)
twobit_decompress_i32_kernel(const int* __restrict__ codes,
                             float* __restrict__ out, long long n, float thr,
                             int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    for (long long j = i; j < n4; j += stride) {
      const int4 c = reinterpret_cast<const int4*>(codes)[j];
      float4 o;
      o.x = __fmul_rn(__int2float_rn(c.x), thr);
      o.y = __fmul_rn(__int2float_rn(c.y), thr);
      o.z = __fmul_rn(__int2float_rn(c.z), thr);
      o.w = __fmul_rn(__int2float_rn(c.w), thr);
      reinterpret_cast<float4*>(out)[j] = o;
    }
    done = n4 << 2;
  }
  for (long long j = done + i; j < n; j += stride)
    out[j] = __fmul_rn(__int2float_rn(codes[j]), thr);
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

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)(uint8_t)a | ((int)(uint8_t)b << 8) | ((int)(uint8_t)c << 16) |
         ((int)(uint8_t)d << 24);
}

__device__ __forceinline__ int compress_word(const float4& g, float4& r,
                                             float thr, float neg_thr) {
  const int8_t c0 = compress1(g.x, r.x, thr, neg_thr, &r.x);
  const int8_t c1 = compress1(g.y, r.y, thr, neg_thr, &r.y);
  const int8_t c2 = compress1(g.z, r.z, thr, neg_thr, &r.z);
  const int8_t c3 = compress1(g.w, r.w, thr, neg_thr, &r.w);
  return pack4(c0, c1, c2, c3);
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
        t.codes[e] = compress1(t.grad[e], t.res[e], thr, neg_thr, &o);
        t.res[e] = o;
      }
    }
  }
}

__device__ __forceinline__ float4 decompress_word(int w, float thr) {
  float4 o;
  o.x = __fmul_rn(__int2float_rn((int)(int8_t)(w & 0xff)), thr);
  o.y = __fmul_rn(__int2float_rn((int)(int8_t)((w >> 8) & 0xff)), thr);
  o.z = __fmul_rn(__int2float_rn((int)(int8_t)((w >> 16) & 0xff)), thr);
  o.w = __fmul_rn(__int2float_rn((int)(int8_t)((w >> 24) & 0xff)), thr);
  return o;
}

// n int8 codes into float32, the same groups and tiles with no table:
// lane l loads codes 16l..16l+15 of its warp's group with one 16-byte load
// into the stage, then stores float4 number 32u + l (u = 0..3) from stage
// word 32u + l. vec: codes and out both
// 16-byte aligned; else, and for a ragged last group, one code a lane.
__global__ void __launch_bounds__(kThreads)
twobit_decompress_kernel(const int8_t* __restrict__ codes,
                         float* __restrict__ out, long long n, float thr,
                         int vec) {
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
      float4* __restrict__ op = reinterpret_cast<float4*>(out + e0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        __stcs(op + 32 * u + lane, decompress_word(words[32 * u + lane], thr));
      __syncwarp();   // the stage is read before the next group writes it
    } else {
      const long long e1 = e0 + kWarpElems < n ? e0 + kWarpElems : n;
      for (long long e = e0 + lane; e < e1; e += 32)
        out[e] = __fmul_rn(__int2float_rn((int)codes[e]), thr);
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

// code_bytes: 1 (int8 codes) or 4 (int32 codes). vec: non-zero when codes
// and out are 16-byte aligned. n_blocks: the int8 kernel's blocks, at most
// one full wave (mxtt_twobit_wave); the int32 loop sizes its own grid.
extern "C" int mxtt_twobit_decompress(const void* codes, int code_bytes,
                                      float* out, long long n, float thr,
                                      int vec, int n_blocks, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (code_bytes == 1) {
    if (n_blocks < 1) return (int)cudaErrorInvalidValue;
    twobit_decompress_kernel<<<n_blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const int8_t*)codes, out, n, thr, vec);
  } else if (code_bytes == 4) {
    twobit_decompress_i32_kernel<<<grid_for(n, vec), kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const int*)codes, out, n, thr, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
                      &per_sm, twobit_decompress_kernel, kThreads, 0)
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
