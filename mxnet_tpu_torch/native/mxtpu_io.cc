// The port's native IO library: RecordIO framing, image batch
// normalisation, the JPEG decode with its align-corners resize, the
// fused crop/mirror/jitter augmenter, and three parts that take the place
// of the JAX package's PIL calls: a PNG unfilter and conversion to RGB,
// Pillow's BILINEAR resample (Resample.c), and the PNG scanline filter of
// the encoder. Every entry point has a plain numpy version in
// native/__init__.py that the tests hold it against bit for bit.
//
// A copy of mxnet_tpu/native/mxtpu_io.cc (scan :27, read :60, normalize
// :81, pack :105, decode_resize_one :153-215, augment_into :222-237, the
// OpenMP batch entries :246 and :284), kept as the port's own source.
//
// Build (native/__init__.py): g++ -O3 [-fopenmp] -shared -fPIC -std=c++17
// -ffp-contract=off [-ljpeg], or -DMXTPU_NO_JPEG without libjpeg. No
// -march=native and no contraction: a fused multiply-add would part the
// float resizes and the normalisation from the plain versions.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// The hot loops are also compiled for AVX2 and picked at load time where
// the CPU has it (integer and unfused float arithmetic: the same bytes
// either way).
#if defined(__x86_64__) && defined(__GNUC__) && !defined(__clang__)
#define MXTPU_CLONES __attribute__((target_clones("avx2", "default")))
#else
#define MXTPU_CLONES
#endif

extern "C" {

static const uint32_t kMagic = 0xced7230a;
static const uint32_t kLRecBits = 29;

// The number of records of a RecordIO file, each record's payload offset
// and length in caller arrays of capacity `cap`. Errors are negative:
// -1 the file cannot be opened (errno in *where), -2 bad magic and -3 a
// multi-part record (cflag != 0), both at the byte offset in *where, -4
// more than `cap` records.
long long mxtpu_recordio_scan(const char* path, uint64_t* offsets,
                              uint64_t* lengths, long long cap,
                              long long* where) {
  FILE* f = fopen(path, "rb");
  if (!f) { *where = errno; return -1; }
  long long n = 0;
  uint32_t header[2];
  for (;;) {
    long pos = ftell(f);
    size_t got = fread(header, sizeof(uint32_t), 2, f);
    if (got != 2) break;  // EOF
    long long rc = 0;
    if (header[0] != kMagic) rc = -2;
    else if (header[1] >> kLRecBits) rc = -3;
    else if (n >= cap) rc = -4;
    if (rc) { *where = pos; fclose(f); return rc; }
    uint64_t len = header[1] & ((1u << kLRecBits) - 1);
    offsets[n] = (uint64_t)pos + 2 * sizeof(uint32_t);
    lengths[n] = len;
    ++n;
    uint64_t padded = (len + 3u) & ~3ull;
    if (fseek(f, (long)(pos + 8 + (long)padded), SEEK_SET) != 0) break;
  }
  fclose(f);
  return n;
}

// The payloads of `count` records (offsets and lengths from the scan)
// into one buffer `dst` of the lengths' sum. 0 on success.
int mxtpu_recordio_read(const char* path, const uint64_t* offsets,
                        const uint64_t* lengths, long long count,
                        uint8_t* dst) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t* p = dst;
  for (long long i = 0; i < count; ++i) {
    if (fseek(f, (long)offsets[i], SEEK_SET) != 0) { fclose(f); return -1; }
    if (fread(p, 1, (size_t)lengths[i], f) != lengths[i]) {
      fclose(f);
      return -1;
    }
    p += lengths[i];
  }
  fclose(f);
  return 0;
}

// n HWC uint8 images -> CHW float32, ((x * scale) - mean) * std_inv per
// channel, all in float32.
MXTPU_CLONES
void mxtpu_normalize_hwc_u8_to_chw_f32(const uint8_t* src, float* dst,
                                       long long n, long long h,
                                       long long w, long long c,
                                       const float* mean,
                                       const float* std_inv,
                                       float scale) {
  const long long hw = h * w;
  for (long long i = 0; i < n; ++i) {
    const uint8_t* img = src + i * hw * c;
    float* out = dst + i * hw * c;
    if (c == 3) {   // one pass over the pixels, three planes written
      const float m0 = mean ? mean[0] : 0.0f, m1 = mean ? mean[1] : 0.0f,
                  m2 = mean ? mean[2] : 0.0f;
      const float s0 = std_inv ? std_inv[0] : 1.0f,
                  s1 = std_inv ? std_inv[1] : 1.0f,
                  s2 = std_inv ? std_inv[2] : 1.0f;
      float* __restrict p0 = out;
      float* __restrict p1 = out + hw;
      float* __restrict p2 = out + 2 * hw;
      const uint8_t* __restrict px = img;
      for (long long p = 0; p < hw; ++p) {
        p0[p] = ((float)px[p * 3 + 0] * scale - m0) * s0;
        p1[p] = ((float)px[p * 3 + 1] * scale - m1) * s1;
        p2[p] = ((float)px[p * 3 + 2] * scale - m2) * s2;
      }
      continue;
    }
    for (long long ch = 0; ch < c; ++ch) {
      const float m = mean ? mean[ch] : 0.0f;
      const float s = std_inv ? std_inv[ch] : 1.0f;
      float* plane = out + ch * hw;
      for (long long p = 0; p < hw; ++p) {
        plane[p] = ((float)img[p * c + ch] * scale - m) * s;
      }
    }
  }
}

// magic | lrecord | payload | pad for each payload into dst (sized by the
// caller as the sum of 8 + padded lengths); the bytes written.
long long mxtpu_recordio_pack(const uint8_t* payloads,
                              const uint64_t* lengths, long long count,
                              uint8_t* dst) {
  const uint8_t* src = payloads;
  uint8_t* p = dst;
  for (long long i = 0; i < count; ++i) {
    uint32_t len = (uint32_t)lengths[i];
    uint32_t header[2] = {kMagic, len};
    memcpy(p, header, 8);
    p += 8;
    memcpy(p, src, len);
    src += len;
    p += len;
    uint32_t pad = ((len + 3u) & ~3u) - len;
    memset(p, 0, pad);
    p += pad;
  }
  return (long long)(p - dst);
}

}  // extern "C"

namespace {

// Crop (oh, ow) at (cy, cx) from a (.., dw) RGB image, mirror when
// `mirror`, scale each channel by jit[c] (float32 multiply, +0.5,
// truncate, clamp 255) into `out`.
void augment_into(const uint8_t* src, int dw, int cy, int cx, int oh,
                  int ow, int mirror, const float* jit, uint8_t* out) {
  for (int y = 0; y < oh; ++y) {
    const uint8_t* srow = src + (size_t(cy + y) * dw + cx) * 3;
    uint8_t* drow = out + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const uint8_t* sp = srow + (mirror ? (ow - 1 - x) : x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = float(sp[c]) * jit[c] + 0.5f;
        drow[x * 3 + c] = v >= 255.0f ? 255 : uint8_t(v);
      }
    }
  }
}

const float kOnes[3] = {1.0f, 1.0f, 1.0f};

// ---------------------------------------------------------------------
// Pillow's BILINEAR resample of an 8-bit RGB image (libImaging/Resample.c:
// precompute_coeffs, normalize_coeffs_8bpc, ImagingResampleHorizontal_8bpc,
// ImagingResampleVertical_8bpc, ImagingResampleInner): separable, the
// triangle filter's support widened by the downscale factor, weights in
// double normalised to sum 1, then 8-bit fixed point with 22 fraction
// bits, accumulated in int32 from a rounding half.

const int kPrecisionBits = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// bounds (xmin, xmax) and fixed-point weights of every output pixel
int precompute_coeffs(int in_size, float in0, float in1, int out_size,
                      std::vector<int>* bounds, std::vector<int32_t>* kk) {
  double filterscale, scale;
  filterscale = scale = (double)(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = 1.0 * filterscale;
  const int ksize = (int)ceil(support) * 2 + 1;
  std::vector<double> pre((size_t)out_size * ksize);
  bounds->assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[(size_t)xx * ksize];
    int x;
    for (x = 0; x < xmax; ++x) {
      const double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (; x < ksize; ++x) k[x] = 0;
    (*bounds)[xx * 2 + 0] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->resize(pre.size());
  for (size_t i = 0; i < pre.size(); ++i) {
    (*kk)[i] = pre[i] < 0 ? (int)(-0.5 + pre[i] * (1 << kPrecisionBits))
                          : (int)(0.5 + pre[i] * (1 << kPrecisionBits));
  }
  return ksize;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> kPrecisionBits);
}

// Pillow's horizontal pass over source rows [r0, r1), output columns
// [cx, cx + ow): per pixel a short run of taps, which the vectorizer only
// slows (so it is not given an AVX2 clone).
__attribute__((noinline))
void horizontal_pass(const uint8_t* src, int w, int r0, int r1, int cx,
                     int ow, const int* bh, const int32_t* kh, int ksh,
                     uint8_t* out) {
  const size_t tstride = (size_t)ow * 3;
  for (int r = r0; r < r1; ++r) {
    const uint8_t* row = src + (size_t)r * w * 3;
    uint8_t* orow = out + (size_t)(r - r0) * tstride;
    for (int xx = 0; xx < ow; ++xx) {
      const int xmin = bh[(cx + xx) * 2], xmax = bh[(cx + xx) * 2 + 1];
      const int32_t* k = &kh[(size_t)(cx + xx) * ksh];
      const uint8_t* p = row + (size_t)xmin * 3;
      int ss0 = 1 << (kPrecisionBits - 1), ss1 = ss0, ss2 = ss0;
      for (int x = 0; x < xmax; ++x, p += 3) {
        ss0 += p[0] * k[x];
        ss1 += p[1] * k[x];
        ss2 += p[2] * k[x];
      }
      orow[xx * 3 + 0] = clip8(ss0);
      orow[xx * 3 + 1] = clip8(ss1);
      orow[xx * 3 + 2] = clip8(ss2);
    }
  }
}

// Image.resize((dw, dh), Image.BILINEAR) of an (h, w, 3) image, computed
// only on the window (oh, ow) at (cy, cx) of the (dh, dw) result and
// written through the augmenter: mirrored when `mirror`, each channel
// scaled by jit[c] (float32 multiply, +0.5, truncate, clamp 255) when
// `jit` is not NULL. Every output pixel is its own sum over the source, so
// the window holds the same values as the whole resample would.
//
// With `planes` (not NULL) the window is also written normalised, as
// mxtpu_normalize_hwc_u8_to_chw_f32 computes it from the uint8 values:
// three float32 planes of oh * ow, ((v * scale) - mean[c]) * std_inv[c];
// `out` may then be NULL.
MXTPU_CLONES
void resample_window(const uint8_t* src, int h, int w, int dh, int dw,
                     int cy, int cx, int oh, int ow, int mirror,
                     const float* jit, uint8_t* out, float* planes,
                     const float* mean, const float* std_inv, float scale) {
  const bool need_h = dw != w, need_v = dh != h;
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  int ksh = 0, ksv = 0;
  if (need_h) ksh = precompute_coeffs(w, 0.f, (float)w, dw, &bh, &kh);
  if (need_v) ksv = precompute_coeffs(h, 0.f, (float)h, dh, &bv, &kv);
  // the source rows the window reads
  int r0 = cy, r1 = cy + oh;
  if (need_v) {
    r0 = bv[cy * 2];
    r1 = bv[(cy + oh - 1) * 2] + bv[(cy + oh - 1) * 2 + 1];
  }
  // horizontal pass over those rows, window columns only (the source's
  // own columns when the width is kept)
  const uint8_t* tmp;
  size_t tstride;
  std::unique_ptr<uint8_t[]> hbuf;
  if (need_h) {
    tstride = (size_t)ow * 3;
    hbuf.reset(new uint8_t[(size_t)(r1 - r0) * tstride]);
    horizontal_pass(src, w, r0, r1, cx, ow, bh.data(), kh.data(), ksh,
                    hbuf.get());
    tmp = hbuf.get();
  } else {
    tstride = (size_t)w * 3;
    tmp = src + (size_t)r0 * tstride + (size_t)cx * 3;
  }
  const int n = ow * 3;
  std::unique_ptr<int32_t[]> acc(new int32_t[n]);
  std::unique_ptr<uint8_t[]> line(new uint8_t[n]);
  std::unique_ptr<uint8_t[]> line2(out ? nullptr : new uint8_t[n]);
  const float m0 = mean ? mean[0] : 0.0f, m1 = mean ? mean[1] : 0.0f,
              m2 = mean ? mean[2] : 0.0f;
  const float s0 = std_inv ? std_inv[0] : 1.0f,
              s1 = std_inv ? std_inv[1] : 1.0f,
              s2 = std_inv ? std_inv[2] : 1.0f;
  for (int yy = 0; yy < oh; ++yy) {
    const uint8_t* v;
    if (need_v) {
      const int ymin = bv[(cy + yy) * 2] - r0, ymax = bv[(cy + yy) * 2 + 1];
      const int32_t* k = &kv[(size_t)(cy + yy) * ksv];
      for (int j = 0; j < n; ++j) acc[j] = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* row = tmp + (size_t)(y + ymin) * tstride;
        const int32_t ky = k[y];
        for (int j = 0; j < n; ++j) acc[j] += row[j] * ky;
      }
      for (int j = 0; j < n; ++j) line[j] = clip8(acc[j]);
      v = line.get();
    } else {
      v = tmp + (size_t)yy * tstride;
    }
    uint8_t* orow = out ? out + (size_t)yy * n : line2.get();
    for (int x = 0; x < ow; ++x) {
      const uint8_t* sp = v + (size_t)(mirror ? ow - 1 - x : x) * 3;
      uint8_t* dp = orow + (size_t)x * 3;
      if (jit) {
        for (int c = 0; c < 3; ++c) {
          const float f = float(sp[c]) * jit[c] + 0.5f;
          dp[c] = f >= 255.0f ? 255 : uint8_t(f);
        }
      } else {
        dp[0] = sp[0]; dp[1] = sp[1]; dp[2] = sp[2];
      }
    }
    if (planes) {
      const size_t hw = (size_t)oh * ow;
      float* p0 = planes + (size_t)yy * ow;
      float* p1 = p0 + hw;
      float* p2 = p1 + hw;
      for (int x = 0; x < ow; ++x) {
        p0[x] = ((float)orow[x * 3 + 0] * scale - m0) * s0;
        p1[x] = ((float)orow[x * 3 + 1] * scale - m1) * s1;
        p2[x] = ((float)orow[x * 3 + 2] * scale - m2) * s2;
      }
    }
  }
}

void resample_bilinear(const uint8_t* src, int h, int w, int oh, int ow,
                       uint8_t* dst) {
  resample_window(src, h, w, oh, ow, 0, 0, oh, ow, 0, nullptr, dst, nullptr,
                  nullptr, nullptr, 1.0f);
}

// ---------------------------------------------------------------------
// PNG: the inflated IDAT stream (one filter-type byte, then the filtered
// bytes, per scanline) -> RGB as PIL's convert("RGB") gives it: gray is
// copied to three channels (1, 2 and 4-bit gray scaled to 0-255 as PIL's
// unpackers do), a palette index is looked up (an index past the palette
// reads black), alpha is dropped. 8-bit samples, and palettes of 1-8 bits.

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// CRC-32 (zlib's polynomial) of `n` bytes, as zlib.crc32(bytes).
uint32_t crc32_of(const uint8_t* p, uint64_t n) {
  static uint32_t table[256];
  static const bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xedb88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xffffffffu;
  for (uint64_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// Unfilter in place into `rows` (h rows of `stride` bytes, filter bytes
// dropped). 0, or -2 for a bad filter type, -3 for short data.
MXTPU_CLONES
int unfilter(const uint8_t* raw, long long raw_len, int h, long long stride,
             int bpp, uint8_t* rows) {
  if (raw_len < (long long)h * (stride + 1)) return -3;
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + (size_t)y * (stride + 1);
    const int ft = in[0];
    ++in;
    uint8_t* cur = rows + (size_t)y * stride;
    const uint8_t* prev = y ? cur - stride : nullptr;
    switch (ft) {
      case 0:
        memcpy(cur, in, stride);
        break;
      case 1: {
        const long long head = bpp < stride ? bpp : stride;
        for (long long i = 0; i < head; ++i) cur[i] = in[i];
        if (bpp == 3 && stride % 3 == 0) {   // RGB: the sums in registers
          uint8_t a = cur[0], b = cur[1], c = cur[2];
          for (long long i = 3; i < stride; i += 3) {
            a = uint8_t(a + in[i]);
            b = uint8_t(b + in[i + 1]);
            c = uint8_t(c + in[i + 2]);
            cur[i] = a; cur[i + 1] = b; cur[i + 2] = c;
          }
        } else {
          for (long long i = head; i < stride; ++i)
            cur[i] = uint8_t(in[i] + cur[i - bpp]);
        }
        break;
      }
      case 2:
        for (long long i = 0; i < stride; ++i)
          cur[i] = uint8_t(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = uint8_t(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return -2;
    }
  }
  return 0;
}

// -1 unsupported format, -2 bad filter, -3 short data, 0 success
int png_to_rgb(const uint8_t* raw, long long raw_len, int w, int h,
               int depth, int color_type, const uint8_t* palette,
               int palette_n, uint8_t* rgb) {
  const int ch = channels_of(color_type);
  if (!ch || w <= 0 || h <= 0) return -1;
  if (depth != 8 && !((color_type == 0 || color_type == 3) &&
                      (depth == 1 || depth == 2 || depth == 4)))
    return -1;
  const long long stride = ((long long)w * ch * depth + 7) / 8;
  const int bpp = (ch * depth + 7) / 8;
  if (color_type == 2 && depth == 8)   // RGB: the rows are the image
    return unfilter(raw, raw_len, h, stride, bpp, rgb);
  std::unique_ptr<uint8_t[]> buf(new uint8_t[(size_t)h * stride]);
  uint8_t* rows_p = buf.get();
  const int rc = unfilter(raw, raw_len, h, stride, bpp, rows_p);
  if (rc) return rc;
  const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  const int mask = (1 << depth) - 1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = rows_p + (size_t)y * stride;
    uint8_t* o = rgb + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      uint8_t* p = o + (size_t)x * 3;
      if (depth < 8) {
        const long long bit = (long long)x * depth;
        const int v = (r[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
        if (color_type == 3) {
          if (v < palette_n) {
            memcpy(p, palette + v * 3, 3);
          } else {
            p[0] = p[1] = p[2] = 0;
          }
        } else {
          p[0] = p[1] = p[2] = uint8_t(v * scale);
        }
        continue;
      }
      const uint8_t* s = r + (size_t)x * ch;
      switch (color_type) {
        case 0:
        case 4:
          p[0] = p[1] = p[2] = s[0];
          break;
        case 2:
        case 6:
          p[0] = s[0]; p[1] = s[1]; p[2] = s[2];
          break;
        case 3:
          if (s[0] < palette_n) {
            memcpy(p, palette + s[0] * 3, 3);
          } else {
            p[0] = p[1] = p[2] = 0;
          }
          break;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Image.resize((ow, oh), Image.BILINEAR) of an (h, w, 3) uint8 image.
void mxtpu_resample_bilinear(const uint8_t* src, int h, int w, int oh,
                             int ow, uint8_t* dst) {
  resample_bilinear(src, h, w, oh, ow, dst);
}

// Crop + mirror + jitter of one (.., dw, 3) image (NULL jit: factor 1).
void mxtpu_augment(const uint8_t* src, int dw, int cy, int cx, int oh,
                   int ow, int mirror, const float* jit, uint8_t* out) {
  augment_into(src, dw, cy, cx, oh, ow, mirror, jit ? jit : kOnes, out);
}

// The inflated IDAT stream of one non-interlaced PNG -> (h, w, 3) RGB.
// 0 on success, -1 an unsupported format, -2 a bad filter type, -3 data
// shorter than the image.
int mxtpu_png_to_rgb(const uint8_t* raw, long long raw_len, int w, int h,
                     int depth, int color_type, const uint8_t* palette,
                     int palette_n, uint8_t* rgb) {
  return png_to_rgb(raw, raw_len, w, h, depth, color_type, palette,
                    palette_n, rgb);
}

// One PNG's inflated stream -> RGB -> Pillow's BILINEAR resample to
// (dh, dw) where the size differs -> crop (oh, ow) at (cy, cx), mirror,
// jitter (NULL: none) into `out` (oh, ow, 3), computing the resample on
// the window only; with `planes`, also normalised into three float32
// planes (resample_window; `out` may then be NULL). Returns as
// mxtpu_png_to_rgb (-1 also for a window outside (dh, dw)).
int mxtpu_png_decode_augment(const uint8_t* raw, long long raw_len, int w,
                             int h, int depth, int color_type,
                             const uint8_t* palette, int palette_n, int dh,
                             int dw, int oh, int ow, int cy, int cx,
                             int mirror, const float* jit, uint8_t* out,
                             const float* mean, const float* std_inv,
                             float scale, float* planes) {
  if (cy < 0 || cx < 0 || cy + oh > dh || cx + ow > dw) return -1;
  if (!out && !planes) return -1;
  std::unique_ptr<uint8_t[]> rgb(new uint8_t[(size_t)h * w * 3]);
  const int rc = png_to_rgb(raw, raw_len, w, h, depth, color_type, palette,
                            palette_n, rgb.get());
  if (rc) return rc;
  resample_window(rgb.get(), h, w, dh, dw, cy, cx, oh, ow, mirror, jit,
                  out, planes, mean, std_inv, scale);
  return 0;
}

// The chunks of a PNG payload of `len` bytes, walked as png_info_plain
// walks them (up to IEND): IHDR's seven fields into `ihdr` (width,
// height, depth, color type, compression, filter, interlace), PLTE's
// offset and length into `plte` (0, 0 without one), each IDAT's offset
// and length into `idat` (pairs, the first `idat_cap` of them), the CRCs
// of IHDR and PLTE checked. Returns the number of IDAT chunks, or -1 a
// bad signature, -2 a truncated chunk, -3 a CRC mismatch in IHDR or PLTE
// (the chunk's offset in *where), -4 no IHDR or no IDAT, -5 an IHDR of
// the wrong length.
long long mxtpu_png_info(const uint8_t* buf, long long len, int* ihdr,
                         long long* plte, long long* idat,
                         long long idat_cap, long long* where) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                  '\n'};
  if (len < 8 || memcmp(buf, kSig, 8) != 0) return -1;
  bool have_ihdr = false;
  long long n_idat = 0;
  plte[0] = plte[1] = 0;
  long long pos = 8;
  while (pos + 8 <= len) {
    const uint32_t length = be32(buf + pos);
    const uint8_t* kind = buf + pos + 4;
    if (pos + 12 + (long long)length > len) return -2;
    const uint8_t* data = buf + pos + 8;
    const bool is_ihdr = memcmp(kind, "IHDR", 4) == 0;
    const bool is_plte = memcmp(kind, "PLTE", 4) == 0;
    if (is_ihdr || is_plte) {
      if (crc32_of(kind, 4 + length) != be32(data + length)) {
        *where = pos;
        return -3;
      }
    }
    if (is_ihdr) {
      if (length != 13) return -5;
      ihdr[0] = int(be32(data));
      ihdr[1] = int(be32(data + 4));
      for (int i = 0; i < 5; ++i) ihdr[2 + i] = data[8 + i];
      have_ihdr = true;
    } else if (is_plte) {
      plte[0] = pos + 8;
      plte[1] = length;
    } else if (memcmp(kind, "IDAT", 4) == 0) {
      if (n_idat < idat_cap) {
        idat[2 * n_idat] = pos + 8;
        idat[2 * n_idat + 1] = length;
      }
      ++n_idat;
    } else if (memcmp(kind, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + (long long)length;
  }
  if (!have_ihdr || !n_idat) return -4;
  return n_idat;
}

// The encoder's filtered scanlines of an (h, w, c) uint8 image: each row
// a filter-type byte (0 None, 1 Sub) and the filtered bytes, into `out`
// of h * (w * c + 1) bytes.
void mxtpu_png_filter(const uint8_t* img, int h, int w, int c, int filter,
                      uint8_t* out) {
  const size_t stride = (size_t)w * c;
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = img + y * stride;
    uint8_t* o = out + y * (stride + 1);
    o[0] = uint8_t(filter);
    if (filter == 1) {
      for (size_t i = 0; i < stride; ++i)
        o[1 + i] = uint8_t(r[i] - (i >= (size_t)c ? r[i - c] : 0));
    } else {
      memcpy(o + 1, r, stride);
    }
  }
}

int mxtpu_has_jpeg(void) {
#ifdef MXTPU_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

}  // extern "C"

// ------------------------------------------------------------------------
// JPEG (libjpeg): the batch decode with its align-corners bilinear resize
// (float32, +0.5), one OpenMP thread per image, and an encoder for
// recordio.pack_img. Compiled out without libjpeg (-DMXTPU_NO_JPEG).

#ifndef MXTPU_NO_JPEG
#include <csetjmp>
#include <jpeglib.h>

namespace {

struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  JerrMgr* e = reinterpret_cast<JerrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// decode one JPEG to RGB at its own size; a malloc'd buffer, or nullptr
uint8_t* decode_rgb(const uint8_t* buf, uint64_t len, int* ph, int* pw) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  // volatile: written between setjmp and longjmp
  uint8_t* volatile pixels = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(pixels);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  const int stride = w * 3;
  pixels = static_cast<uint8_t*>(malloc(static_cast<size_t>(h) * stride));
  if (!pixels) { jpeg_destroy_decompress(&cinfo); return nullptr; }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels + static_cast<size_t>(cinfo.output_scanline) *
                   stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *ph = h;
  *pw = w;
  return pixels;
}

// align-corners bilinear (h, w) -> (oh, ow), float32, +0.5, truncate
void resize_align_corners(const uint8_t* pixels, int h, int w, int oh,
                          int ow, uint8_t* out) {
  const float sy = oh > 1 ? float(h - 1) / float(oh - 1) : 0.f;
  const float sx = ow > 1 ? float(w - 1) / float(ow - 1) : 0.f;
  for (int y = 0; y < oh; ++y) {
    const float fy = y * sy;
    const int y0 = int(fy), y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const float wy = fy - y0;
    for (int x = 0; x < ow; ++x) {
      const float fx = x * sx;
      const int x0 = int(fx), x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float p00 = pixels[(size_t(y0) * w + x0) * 3 + c];
        const float p01 = pixels[(size_t(y0) * w + x1) * 3 + c];
        const float p10 = pixels[(size_t(y1) * w + x0) * 3 + c];
        const float p11 = pixels[(size_t(y1) * w + x1) * 3 + c];
        const float v = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx +
                        p10 * wy * (1 - wx) + p11 * wy * wx;
        out[(size_t(y) * ow + x) * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

bool decode_resize_one(const uint8_t* buf, uint64_t len, int oh, int ow,
                       uint8_t* out) {
  int h = 0, w = 0;
  uint8_t* pixels = decode_rgb(buf, len, &h, &w);
  if (!pixels) return false;
  resize_align_corners(pixels, h, w, oh, ow, out);
  free(pixels);
  return true;
}

}  // namespace

extern "C" {

// The (h, w) of a JPEG from its header; 0, or -1 when it is not one.
int mxtpu_jpeg_size(const uint8_t* buf, uint64_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// One JPEG -> (h, w, 3) RGB at its own size (h, w from mxtpu_jpeg_size).
// 0 on success, -1 on a decode failure or another size.
int mxtpu_jpeg_decode(const uint8_t* buf, uint64_t len, int h, int w,
                      uint8_t* out) {
  int dh = 0, dw = 0;
  uint8_t* pixels = decode_rgb(buf, len, &dh, &dw);
  if (!pixels) return -1;
  const int rc = (dh == h && dw == w) ? 0 : -1;
  if (!rc) memcpy(out, pixels, (size_t)h * w * 3);
  free(pixels);
  return rc;
}

// `n` JPEGs (at blob + offsets[i], lengths[i]) -> (n, oh, ow, 3) uint8,
// OpenMP over images (`n_threads` bounds the team; <= 0 the default).
// The number decoded; a failed slot is zero-filled and its index listed
// in `failed` (-1 terminated).
long long mxtpu_decode_jpeg_batch(const uint8_t* blob,
                                  const uint64_t* offsets,
                                  const uint64_t* lengths, long long n,
                                  int oh, int ow, uint8_t* out,
                                  long long* failed, int n_threads) {
  long long ok = 0;
  long long nfail = 0;
#ifdef _OPENMP
  // a num_threads clause: omp_set_num_threads is process-global
  const int team = n_threads > 0 ? n_threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) reduction(+:ok) num_threads(team)
#endif
  for (long long i = 0; i < n; ++i) {
    uint8_t* dst = out + static_cast<size_t>(i) * oh * ow * 3;
    if (decode_resize_one(blob + offsets[i], lengths[i], oh, ow, dst)) {
      ++ok;
    } else {
      memset(dst, 0, static_cast<size_t>(oh) * ow * 3);
#ifdef _OPENMP
#pragma omp critical
#endif
      { failed[nfail++] = i; }
    }
  }
  if (nfail < n) failed[nfail] = -1;
  return ok;
}

// `n` JPEGs decoded to (dh, dw), then cropped to (oh, ow) at (crop_y[i],
// crop_x[i]), mirrored where mirror[i], scaled by jitter[i * 3 ..] into
// out (n, oh, ow, 3); NULL crop/mirror/jitter mean 0 / no flip / 1.
// Returns and fails as mxtpu_decode_jpeg_batch.
long long mxtpu_decode_augment_batch(
    const uint8_t* blob, const uint64_t* offsets, const uint64_t* lengths,
    long long n, int dh, int dw, int oh, int ow, const int32_t* crop_y,
    const int32_t* crop_x, const uint8_t* mirror, const float* jitter,
    uint8_t* out, long long* failed, int n_threads) {
  long long ok = 0;
  long long nfail = 0;
#ifdef _OPENMP
  const int team = n_threads > 0 ? n_threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) reduction(+:ok) num_threads(team)
#endif
  for (long long i = 0; i < n; ++i) {
    uint8_t* dst = out + static_cast<size_t>(i) * oh * ow * 3;
    uint8_t* scratch =
        static_cast<uint8_t*>(malloc(static_cast<size_t>(dh) * dw * 3));
    const bool good = scratch != nullptr &&
        decode_resize_one(blob + offsets[i], lengths[i], dh, dw, scratch);
    if (good) {
      augment_into(scratch, dw, crop_y ? crop_y[i] : 0,
                   crop_x ? crop_x[i] : 0, oh, ow,
                   mirror ? mirror[i] : 0,
                   jitter ? jitter + i * 3 : kOnes, dst);
      ++ok;
    } else {
      memset(dst, 0, static_cast<size_t>(oh) * ow * 3);
#ifdef _OPENMP
#pragma omp critical
#endif
      { failed[nfail++] = i; }
    }
    free(scratch);
  }
  if (nfail < n) failed[nfail] = -1;
  return ok;
}

// Baseline JPEG of an (h, w, 3) RGB image at `quality`: *out is a
// malloc'd buffer of *out_len bytes, released with mxtpu_free. 0 on
// success.
int mxtpu_jpeg_encode(const uint8_t* rgb, int h, int w, int quality,
                      uint8_t** out, unsigned long* out_len) {
  jpeg_compress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  *out = nullptr;
  *out_len = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, out, out_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   static_cast<size_t>(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

void mxtpu_free(void* p) { free(p); }

}  // extern "C"
#endif  // MXTPU_NO_JPEG
