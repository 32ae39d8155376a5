// Single-query decode attention against a padded KV cache, for Hopper
// (sm_90a), float32 and bfloat16 inputs.
//
// Replaces the TPU kernel mxnet_tpu/kernels/decode_attention.py:_kernel
// (body _decode_body): one new query per (batch, head), q (B, H, D),
// against k and v (B, H, S, D) of which only the first lengths[b] keys of
// row b are valid. out[b,h] = sum_j softmax_j(scale * q . k_j) v_j over
// j < min(lengths[b], S), accumulated in float32 with an online softmax
// (running max m, normaliser l, final divide by max(l, 1e-30)), written
// in q's dtype.
//
// The TPU kernel walks the cache in block_k-key blocks on a sequential
// grid and skips blocks at or past the length. Here one block of 128
// threads (4 warps) owns one (b, h) and reads only the valid keys: warp w
// takes keys w*4 .. w*4+3, then the next 16, and so on, four keys at a
// time. Lane t holds q[d] and the accumulator for d = t + 32*i; a key's
// score is a warp-wide sum of the lanes' products (xor shuffles). Each
// warp keeps its own (m, l, acc); at the end the four are merged through
// shared memory. Cache rows past the length are never read, so the cost
// follows the filled cache, not S. Any S >= 1 works (no block-size
// divisibility); lengths above S count as S.
//
// What bounds it: each valid key is read once and used for 2*D
// multiply-adds, so device memory bounds it (2 * D * dtype bytes per
// valid key and head). The design leaves the card underoccupied when
// B*H is small (one block per (b, h): 384 blocks of 4 warps at B*H = 384
// give about 12 of an SM's 64 warp slots) and serialises a long row on
// one SM; splitting the KV axis across blocks (flash-decoding) is later
// work.
//
// The launch function is plain C: it returns cudaGetLastError() after the
// launch and never synchronises.

#include "flash_common.cuh"

namespace {

using mxtt_flash::load1;
using mxtt_flash::store1;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;      // keys a warp handles per step
constexpr int kMaxD = 512;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int heads, int s_max, int d, float scale) {
  __shared__ float s_acc[kWarps][kMaxD];
  __shared__ float s_m[kWarps], s_l[kWarps];

  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int len = lengths[bh / heads];
  len = len < s_max ? len : s_max;
  const T* kb = k + (size_t)bh * s_max * d;
  const T* vb = v + (size_t)bh * s_max * d;

  float qr[NI], acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int e = lane + 32 * i;
    qr[i] = e < d ? load1(q + (size_t)bh * d + e) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = warp * kUnroll; j0 < len; j0 += kWarps * kUnroll) {
    float kr[kUnroll][NI], vr[kUnroll][NI];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = j0 + u < len;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int e = lane + 32 * i;
        const size_t off = (size_t)(j0 + u) * d + e;
        kr[u][i] = valid && e < d ? load1(kb + off) : 0.f;
        vr[u][i] = valid && e < d ? load1(vb + off) : 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) part = fmaf(qr[i], kr[u][i], part);
      s[u] = warp_sum(part);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = j0 + u < len ? s[u] * scale : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    float p[kUnroll], p_sum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = expf(s[u] - m_new);
      p_sum += p[u];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vr[u][i], a);
      acc[i] = a;
    }
    m = m_new;
  }

  // merge the four warps' partial softmax states
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int e = lane + 32 * i;
    if (e < d) s_acc[warp][e] = acc[i];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
  float f[kWarps], l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(s_m[w] - m_all);   // 0 for a warp that saw no key
    l_all += s_l[w] * f[w];
  }
  const float denom = fmaxf(l_all, 1e-30f);
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(s_acc[w][e], f[w], a);
    store1(out + (size_t)bh * d + e, a / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int bh, int heads, int s_max, int d, float scale,
           cudaStream_t stream) {
  const int ni = (d + 31) / 32;
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  T* ot = (T*)out;
#define MXTT_DECODE(N)                                                       \
  decode_attention_kernel<T, N><<<bh, kThreads, 0, stream>>>(              \
      qt, kt, vt, lengths, ot, heads, s_max, d, scale)
  if (ni <= 1) MXTT_DECODE(1);
  else if (ni <= 2) MXTT_DECODE(2);
  else if (ni <= 4) MXTT_DECODE(4);
  else if (ni <= 8) MXTT_DECODE(8);
  else if (ni <= 16) MXTT_DECODE(16);
  else return (int)cudaErrorInvalidValue;
#undef MXTT_DECODE
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. bh = B * H blocks; lengths is int32 (B,).
extern "C" int mxtt_decode_attention(const void* q, const void* k,
                                     const void* v, const int* lengths,
                                     void* out, int bh, int heads, int s_max,
                                     int d, float scale, int dtype,
                                     void* stream) {
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, bh, heads, s_max, d, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, bh, heads, s_max, d,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}
