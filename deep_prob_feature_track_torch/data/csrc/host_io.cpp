// The port's native host tier: the decode arithmetic of data/png.py,
// data/io.py and data/jpeg.py in C++, bit for bit with their numpy twins.
//
// Plain C functions on buffers the caller allocates (numpy arrays), bound
// with ctypes.CDLL by data/native_io.py, which drops the GIL around each
// call: a decode on the loader's prefetch thread leaves the interpreter
// free.  Nothing here calls back into Python.  The standard library alone:
// no libpng, zlib or libjpeg (Python's zlib inflates the PNG data, and
// Python parses the files' chunks, markers and tables).
//
// Built with -ffp-contract=off and no -march or -ffast-math, so that every
// float32 operation rounds once, in the order written, on any host.
//
// Return codes: 0 success; HIO_TRUNCATED the JPEG data ends inside a
// block; HIO_CORRUPT a Huffman code no table holds (or a PNG filter byte
// over 4); HIO_UNSUPPORTED sampling factors the decoder does not take.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int HIO_TRUNCATED = 1;
constexpr int HIO_CORRUPT = 2;
constexpr int HIO_UNSUPPORTED = 3;

inline int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ------------------------------------------------------------------ PNG

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return static_cast<uint8_t>((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
}

// One source sample of data/io.py::read_rgb: libpng's 16-to-8 strip, gray
// (1-2 channels) repeated into RGB, alpha dropped.
inline float rgb_sample(const uint8_t* s8, const uint16_t* s16, int64_t pixel,
                        int channels, int c) {
  const int64_t i = pixel * channels + (channels <= 2 ? 0 : c);
  return static_cast<float>(s16 ? static_cast<uint8_t>(s16[i] >> 8) : s8[i]);
}

// read_rgb's axis: half-pixel centres in float32, the neighbours clamped.
void half_pixel_axis(int64_t n_in, int64_t n_out, std::vector<int64_t>& i0,
                     std::vector<int64_t>& i1, std::vector<float>& w) {
  i0.resize(n_out);
  i1.resize(n_out);
  w.resize(n_out);
  const float step = static_cast<float>(n_in) / static_cast<float>(n_out);
  for (int64_t o = 0; o < n_out; ++o) {
    const float f = (static_cast<float>(o) + 0.5f) * step - 0.5f;
    const float fl = std::floor(f);
    const int64_t lo = static_cast<int64_t>(fl);
    w[o] = f - fl;
    i0[o] = clamp64(lo, 0, n_in - 1);
    i1[o] = clamp64(lo + 1, 0, n_in - 1);
  }
}

// resize_linear_cv's axis: centres in float64, clamped to [0, n - 1], the
// left neighbour at most n - 2, the weight rounded to float32.
void cv_axis(int64_t n_in, int64_t n_out, double scale, std::vector<int64_t>& i0,
             std::vector<int64_t>& i1, std::vector<float>& w) {
  i0.resize(n_out);
  i1.resize(n_out);
  w.resize(n_out);
  const double hi = static_cast<double>(n_in - 1);
  const int64_t last = std::max<int64_t>(n_in - 2, 0);
  for (int64_t o = 0; o < n_out; ++o) {
    double x = (static_cast<double>(o) + 0.5) / scale - 0.5;
    x = x < 0.0 ? 0.0 : (x > hi ? hi : x);
    const int64_t lo = std::min(static_cast<int64_t>(std::floor(x)), last);
    i0[o] = lo;
    i1[o] = std::min(lo + 1, n_in - 1);
    w[o] = static_cast<float>(x - static_cast<double>(lo));
  }
}

// ----------------------------------------------------------------- JPEG

// zigzag position -> natural position, 16 extra entries for a corrupt run
// past the end (as data/jpeg.py::ZIGZAG)
constexpr int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// data/jpeg.py::_entropy_segments: the unstuffed entropy-coded bytes from
// `start`, split at the restart markers; returns the offset of the marker
// that ends them (n where the data runs to the end).
int64_t entropy_segments(const uint8_t* buf, int64_t n, int64_t start,
                         std::vector<std::vector<uint8_t>>& segments) {
  segments.emplace_back();
  int64_t i = start;
  while (true) {
    const void* hit = i < n ? std::memchr(buf + i, 0xFF, n - i) : nullptr;
    const int64_t j = hit ? static_cast<const uint8_t*>(hit) - buf : -1;
    if (j < 0 || j + 1 >= n) {
      segments.back().insert(segments.back().end(), buf + std::min(i, n), buf + n);
      return n;
    }
    segments.back().insert(segments.back().end(), buf + i, buf + j);
    int64_t k = j + 1;
    while (k < n && buf[k] == 0xFF) ++k;  // fill bytes
    if (k >= n) return n;
    const uint8_t m = buf[k];
    if (m == 0x00) {  // a stuffed 0xFF data byte
      segments.back().push_back(0xFF);
      i = k + 1;
    } else if (m >= 0xD0 && m <= 0xD7) {  // RSTn: a new interval
      segments.emplace_back();
      i = k + 1;
    } else {
      return k - 1;
    }
  }
}

// The 32 bits from bit `pos` of one interval's bytes (zeros past the end),
// valid for pos < limit = 8 * (bytes + 1), as data/jpeg.py::_windows.
struct BitWindow {
  const uint8_t* d;  // the bytes and 8 zero bytes after them
  int64_t limit;
  bool at(int64_t pos, uint32_t* out) const {
    if (pos >= limit) return false;
    const uint8_t* p = d + (pos >> 3);
    const uint64_t u40 = (static_cast<uint64_t>(p[0]) << 32) | (static_cast<uint64_t>(p[1]) << 24) |
                         (static_cast<uint64_t>(p[2]) << 16) | (static_cast<uint64_t>(p[3]) << 8) |
                         static_cast<uint64_t>(p[4]);
    *out = static_cast<uint32_t>(u40 >> (8 - (pos & 7)));
    return true;
  }
};

// A 65536-entry lookup from a 16-bit peek to length << 8 | symbol (0 where
// no code starts with those bits), as data/jpeg.py::_huffman_lut.
void huffman_lut(const uint8_t* counts, const uint8_t* symbols, std::vector<int32_t>& lut) {
  lut.assign(1 << 16, 0);
  int code = 0, k = 0;
  for (int length = 1; length <= 16; ++length) {
    for (int c = 0; c < counts[length - 1]; ++c) {
      const int shift = 16 - length;
      std::fill(lut.begin() + (code << shift), lut.begin() + ((code + 1) << shift),
                (length << 8) | symbols[k]);
      ++code;
      ++k;
    }
    code <<= 1;
  }
}

// data/jpeg.py::_decode_blocks over one interval: the blocks `jobs`
// (component, first coefficient) in stream order, DC predictors from 0.
int decode_interval(const std::vector<uint8_t>& data, const int64_t* jobs, int64_t n_jobs,
                    const std::vector<const int32_t*>& dc, const std::vector<const int32_t*>& ac,
                    int32_t* const* coefs, int n_comp) {
  std::vector<uint8_t> padded(data.size() + 8, 0);
  if (!data.empty()) std::memcpy(padded.data(), data.data(), data.size());
  const BitWindow win{padded.data(), 8 * (static_cast<int64_t>(data.size()) + 1)};
  std::vector<int64_t> pred(n_comp, 0);
  int64_t pos = 0;
  uint32_t w;
  for (int64_t j = 0; j < n_jobs; ++j) {
    const int ci = static_cast<int>(jobs[2 * j]);
    int32_t* out = coefs[ci] + jobs[2 * j + 1];
    const int32_t* act = ac[ci];
    if (!win.at(pos, &w)) return HIO_TRUNCATED;
    int32_t e = dc[ci][w >> 16];
    if (!e) return HIO_CORRUPT;
    pos += e >> 8;
    const int s = e & 255;
    if (s) {
      if (!win.at(pos, &w)) return HIO_TRUNCATED;
      if (s > 32) return HIO_CORRUPT;
      int64_t v = static_cast<int64_t>(w >> (32 - s));
      pos += s;
      if (v < (int64_t{1} << (s - 1))) v -= (int64_t{1} << s) - 1;
      pred[ci] += v;
    }
    out[0] = static_cast<int32_t>(pred[ci]);
    int k = 1;
    while (k < 64) {
      if (!win.at(pos, &w)) return HIO_TRUNCATED;
      e = act[w >> 16];
      if (!e) return HIO_CORRUPT;
      pos += e >> 8;
      const int sa = e & 15;
      if (sa) {
        k += (e >> 4) & 15;
        if (!win.at(pos, &w)) return HIO_TRUNCATED;
        int32_t v = static_cast<int32_t>(w >> (32 - sa));
        pos += sa;
        if (v < (1 << (sa - 1))) v -= (1 << sa) - 1;
        out[kZigzag[k]] = v;
        k += 1;
      } else if (((e >> 4) & 15) == 15) {
        k += 16;
      } else {
        break;
      }
    }
  }
  return 0;
}

// libjpeg's jpeg_idct_islow (jidctint.c) as data/jpeg.py::_idct_islow
// computes it: 13-bit constants, two passes, the post-IDCT range limit.
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;
constexpr int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// One 1-D pass: in[k * stride] is input k, out[k * stride] output k.
inline void idct_1d(const int64_t* in, int64_t* out, int stride, int shift) {
  const int64_t z2 = in[2 * stride], z3 = in[6 * stride];
  int64_t z1 = (z2 + z3) * F0_541196100;
  const int64_t tmp2 = z1 + z3 * -F1_847759065;
  const int64_t tmp3 = z1 + z2 * F0_765366865;
  const int64_t tmp0 = (in[0] + in[4 * stride]) * (int64_t{1} << CONST_BITS);
  const int64_t tmp1 = (in[0] - in[4 * stride]) * (int64_t{1} << CONST_BITS);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = in[7 * stride], t1 = in[5 * stride], t2 = in[3 * stride], t3 = in[1 * stride];
  z1 = t0 + t3;
  int64_t zz2 = t1 + t2, zz3 = t0 + t2, z4 = t1 + t3;
  const int64_t z5 = (zz3 + z4) * F1_175875602;
  t0 = t0 * F0_298631336;
  t1 = t1 * F2_053119869;
  t2 = t2 * F3_072711026;
  t3 = t3 * F1_501321110;
  z1 = z1 * -F0_899976223;
  zz2 = zz2 * -F2_562915447;
  zz3 = zz3 * -F1_961570560 + z5;
  z4 = z4 * -F0_390180644 + z5;
  t0 = t0 + z1 + zz3;
  t1 = t1 + zz2 + z4;
  t2 = t2 + zz2 + zz3;
  t3 = t3 + z1 + z4;
  out[0] = descale(tmp10 + t3, shift);
  out[1 * stride] = descale(tmp11 + t2, shift);
  out[2 * stride] = descale(tmp12 + t1, shift);
  out[3 * stride] = descale(tmp13 + t0, shift);
  out[4 * stride] = descale(tmp13 - t0, shift);
  out[5 * stride] = descale(tmp12 - t1, shift);
  out[6 * stride] = descale(tmp11 - t2, shift);
  out[7 * stride] = descale(tmp10 - t3, shift);
}

inline uint8_t range_limit(int64_t x) {
  const int64_t i = x & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

// Natural-order coefficients and quantization table -> 8x8 samples written
// at dst with row pitch `pitch`, clipped to `rows` x `cols`.
void idct_block(const int32_t* coef, const int32_t* quant, uint8_t* dst, int64_t pitch,
                int rows, int cols) {
  int64_t x[64], ws[64], r[64];
  for (int i = 0; i < 64; ++i) x[i] = static_cast<int64_t>(coef[i]) * quant[i];
  for (int col = 0; col < 8; ++col) idct_1d(x + col, ws + col, 8, CONST_BITS - PASS1_BITS);
  for (int row = 0; row < 8; ++row)
    idct_1d(ws + 8 * row, r + 8 * row, 1, CONST_BITS + PASS1_BITS + 3);
  for (int row = 0; row < rows; ++row)
    for (int col = 0; col < cols; ++col) dst[row * pitch + col] = range_limit(r[8 * row + col]);
}

// libjpeg-turbo's fancy upsampling (jdsample.c), as data/jpeg.py's
// _fancy_h2, _fancy_v2, _fancy_h2v2, and the replication of a component at
// most 2 samples wide.  `in` is h x w, `out` (fv*h) x (fh*w).
int upsample(const std::vector<uint8_t>& in, int64_t h, int64_t w, int fh, int fv,
             std::vector<uint8_t>& out) {
  out.resize(static_cast<size_t>(fh * h * fv * w));
  const int64_t ow = fh * w;
  if (fh == 1 && fv == 1) {
    out = in;
  } else if (fh == 1 && fv == 2) {
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* a = &in[y * w];
      const uint8_t* above = &in[std::max<int64_t>(y - 1, 0) * w];
      const uint8_t* below = &in[std::min(y + 1, h - 1) * w];
      for (int64_t x = 0; x < w; ++x) {
        out[(2 * y) * ow + x] = static_cast<uint8_t>((3 * a[x] + above[x] + 1) >> 2);
        out[(2 * y + 1) * ow + x] = static_cast<uint8_t>((3 * a[x] + below[x] + 2) >> 2);
      }
    }
  } else if (fh == 2 && (fv == 1 || fv == 2) && w <= 2) {
    for (int64_t y = 0; y < fv * h; ++y)
      for (int64_t x = 0; x < ow; ++x) out[y * ow + x] = in[(y / fv) * w + x / 2];
  } else if (fh == 2 && fv == 1) {
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* a = &in[y * w];
      uint8_t* o = &out[y * ow];
      for (int64_t x = 0; x < w; ++x) {
        const int prev = a[x > 0 ? x - 1 : 0], next = a[x + 1 < w ? x + 1 : w - 1];
        o[2 * x] = static_cast<uint8_t>((3 * a[x] + prev + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((3 * a[x] + next + 2) >> 2);
      }
    }
  } else if (fh == 2 && fv == 2) {
    std::vector<int> col(w);
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* a = &in[y * w];
      for (int v = 0; v < 2; ++v) {
        const int64_t far_row = v == 0 ? std::max<int64_t>(y - 1, 0) : std::min(y + 1, h - 1);
        const uint8_t* far = &in[far_row * w];
        for (int64_t x = 0; x < w; ++x) col[x] = 3 * a[x] + far[x];
        uint8_t* o = &out[(2 * y + v) * ow];
        for (int64_t x = 0; x < w; ++x) {
          const int prev = col[x > 0 ? x - 1 : 0], next = col[x + 1 < w ? x + 1 : w - 1];
          o[2 * x] = static_cast<uint8_t>((3 * col[x] + prev + 8) >> 4);
          o[2 * x + 1] = static_cast<uint8_t>((3 * col[x] + next + 7) >> 4);
        }
      }
    }
  } else {
    return HIO_UNSUPPORTED;
  }
  return 0;
}

inline uint8_t clip255(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

}  // namespace

extern "C" {

// PNG (data/png.py::read_png): rebuild `height` rows of `width * bpp`
// bytes, each led by its filter byte in `raw` (the inflated IDAT data),
// into `out`; with `depth16` each big-endian byte pair of `out` becomes a
// host-order uint16.
int hio_png_unfilter(const uint8_t* raw, int64_t height, int64_t width, int64_t bpp,
                     int depth16, uint8_t* out) {
  const int64_t row = width * bpp;
  std::vector<uint8_t> zero(row, 0);
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (row + 1) + 1;
    const uint8_t* up = y ? out + (y - 1) * row : zero.data();
    uint8_t* dst = out + y * row;
    switch (raw[y * (row + 1)]) {
      case 0:
        std::memcpy(dst, src, row);
        break;
      case 1:
        for (int64_t i = 0; i < row; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row; ++i) dst[i] = static_cast<uint8_t>(src[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < row; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0, c = i >= bpp ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, up[i], c));
        }
        break;
      default:
        return HIO_CORRUPT;
    }
  }
  if (depth16) {
    for (int64_t i = 0; i < height * row; i += 2) {
      const uint16_t v = static_cast<uint16_t>((out[i] << 8) | out[i + 1]);
      std::memcpy(out + i, &v, 2);
    }
  }
  return 0;
}

// data/io.py::read_rgb of PNG samples `src` ([H, W, channels], uint8, or
// uint16 with `depth16`): float32 [out_h, out_w, 3] in [0, 1], the
// half-pixel bilinear blend of the uint8 values in numpy's float32 order,
// then * (1/255).
int hio_png_rgb(const void* src, int64_t H, int64_t W, int channels, int depth16,
                int64_t out_h, int64_t out_w, float* out) {
  const uint8_t* s8 = depth16 ? nullptr : static_cast<const uint8_t*>(src);
  const uint16_t* s16 = depth16 ? static_cast<const uint16_t*>(src) : nullptr;
  std::vector<int64_t> y0, y1, x0, x1;
  std::vector<float> wy, wx;
  half_pixel_axis(H, out_h, y0, y1, wy);
  half_pixel_axis(W, out_w, x0, x1, wx);
  const float one = 1.0f, inv255 = 1.0f / 255.0f;
  for (int64_t y = 0; y < out_h; ++y) {
    const float b = wy[y], nb = one - b;
    for (int64_t x = 0; x < out_w; ++x) {
      const float a = wx[x], na = one - a;
      const int64_t p00 = y0[y] * W + x0[x], p01 = y0[y] * W + x1[x];
      const int64_t p10 = y1[y] * W + x0[x], p11 = y1[y] * W + x1[x];
      for (int c = 0; c < 3; ++c) {
        const float v = rgb_sample(s8, s16, p00, channels, c) * na * nb +
                        rgb_sample(s8, s16, p01, channels, c) * a * nb +
                        rgb_sample(s8, s16, p10, channels, c) * na * b +
                        rgb_sample(s8, s16, p11, channels, c) * a * b;
        out[(y * out_w + x) * 3 + c] = v * inv255;
      }
    }
  }
  return 0;
}

// data/io.py::read_depth_png of one-channel samples `src` ([H, W], uint8 or
// uint16): float32 [out_h, out_w] metres, nearest at floor(dst * (H /
// out_h)) in float32, * (1 / depth_scale), clipped to [cmin, cmax] where
// `clip`.
int hio_png_depth(const void* src, int64_t H, int64_t W, int depth16, int64_t out_h,
                  int64_t out_w, float depth_scale, int clip, float cmin, float cmax,
                  float* out) {
  const uint8_t* s8 = static_cast<const uint8_t*>(src);
  const uint16_t* s16 = static_cast<const uint16_t*>(src);
  const float sy = static_cast<float>(H) / static_cast<float>(out_h);
  const float sx = static_cast<float>(W) / static_cast<float>(out_w);
  const float inv = 1.0f / depth_scale;
  std::vector<int64_t> xs(out_w);
  for (int64_t x = 0; x < out_w; ++x)
    xs[x] = std::min(static_cast<int64_t>(static_cast<float>(x) * sx), W - 1);
  for (int64_t y = 0; y < out_h; ++y) {
    const int64_t row = std::min(static_cast<int64_t>(static_cast<float>(y) * sy), H - 1) * W;
    for (int64_t x = 0; x < out_w; ++x) {
      const int64_t i = row + xs[x];
      float v = static_cast<float>(depth16 ? s16[i] : s8[i]) * inv;
      if (clip) {
        v = v < cmin ? cmin : v;
        v = v > cmax ? cmax : v;
      }
      out[y * out_w + x] = v;
    }
  }
  return 0;
}

// data/io.py::resize_linear_cv: cv2.resize INTER_LINEAR of float32 [H, W,
// C] by `scale` into [out_h, out_w, C] as OpenCV's bundled IPP computes
// it: columns of every needed row first, then rows, each sample one
// fmaf(p1 - p0, w, p0).
int hio_resize_linear_cv(const float* src, int64_t H, int64_t W, int64_t C, double scale,
                         int64_t out_h, int64_t out_w, float* out) {
  std::vector<int64_t> y0, y1, x0, x1;
  std::vector<float> wy, wx;
  cv_axis(H, out_h, scale, y0, y1, wy);
  cv_axis(W, out_w, scale, x0, x1, wx);
  std::vector<char> needed(H, 0);
  for (int64_t y = 0; y < out_h; ++y) needed[y0[y]] = needed[y1[y]] = 1;
  const int64_t pitch = out_w * C;
  std::vector<float> rows(static_cast<size_t>(H * pitch));
  for (int64_t r = 0; r < H; ++r) {
    if (!needed[r]) continue;
    const float* s = src + r * W * C;
    float* d = &rows[r * pitch];
    for (int64_t x = 0; x < out_w; ++x)
      for (int64_t c = 0; c < C; ++c) {
        const float p0 = s[x0[x] * C + c], p1 = s[x1[x] * C + c];
        d[x * C + c] = std::fmaf(p1 - p0, wx[x], p0);
      }
  }
  for (int64_t y = 0; y < out_h; ++y) {
    const float* r0 = &rows[y0[y] * pitch];
    const float* r1 = &rows[y1[y] * pitch];
    float* d = out + y * pitch;
    for (int64_t i = 0; i < pitch; ++i) d[i] = std::fmaf(r1[i] - r0[i], wy[y], r0[i]);
  }
  return 0;
}

// JPEG (data/jpeg.py::_decode_scan): decode one sequential scan whose
// entropy-coded data starts at buf[start].  The scan's `ns` components are
// frame components scan_comp[i], with Huffman tables dc_tables[i] and
// ac_tables[i], each a DHT table's 16 code counts and then its symbols
// (checked by data/jpeg.py::_check_huffman).
// Frame component ci has sampling factors comp_h/comp_v and
// blocks_w[ci] blocks a row; its natural-order coefficients go to
// coefs[ci] (64 a block).  *end gets the offset of the marker after the
// scan.
int hio_jpeg_scan(const uint8_t* buf, int64_t n, int64_t start, int ns, const int32_t* scan_comp,
                  const uint8_t* const* dc_tables, const uint8_t* const* ac_tables, int n_comp,
                  const int32_t* comp_h,
                  const int32_t* comp_v, const int64_t* blocks_w, int32_t* const* coefs,
                  int64_t X, int64_t Y, int hmax, int vmax, int64_t restart, int64_t* end) {
  std::vector<std::vector<uint8_t>> segments;
  *end = entropy_segments(buf, n, start, segments);
  std::vector<std::vector<int32_t>> luts(2 * ns);
  std::vector<const int32_t*> dc(n_comp, nullptr), ac(n_comp, nullptr);
  for (int i = 0; i < ns; ++i) {
    huffman_lut(dc_tables[i], dc_tables[i] + 16, luts[2 * i]);
    huffman_lut(ac_tables[i], ac_tables[i] + 16, luts[2 * i + 1]);
    dc[scan_comp[i]] = luts[2 * i].data();
    ac[scan_comp[i]] = luts[2 * i + 1].data();
  }
  std::vector<int64_t> jobs;  // (component, first coefficient) pairs
  int64_t per_mcu = 0;
  if (ns == 1) {  // non-interleaved: one block an MCU, the component's own grid
    const int ci = scan_comp[0];
    const int64_t w = (X * comp_h[ci] + hmax - 1) / hmax, h = (Y * comp_v[ci] + vmax - 1) / vmax;
    const int64_t bw = (w + 7) / 8, bh = (h + 7) / 8;
    for (int64_t r = 0; r < bh; ++r)
      for (int64_t c = 0; c < bw; ++c) jobs.insert(jobs.end(), {ci, 64 * (r * blocks_w[ci] + c)});
    per_mcu = 1;
  } else {
    const int64_t mcux = (X + 8 * hmax - 1) / (8 * hmax), mcuy = (Y + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ns; ++i) per_mcu += comp_h[scan_comp[i]] * comp_v[scan_comp[i]];
    jobs.reserve(static_cast<size_t>(2 * mcux * mcuy * per_mcu));
    for (int64_t my = 0; my < mcuy; ++my)
      for (int64_t mx = 0; mx < mcux; ++mx)
        for (int i = 0; i < ns; ++i) {
          const int ci = scan_comp[i];
          for (int by = 0; by < comp_v[ci]; ++by)
            for (int bx = 0; bx < comp_h[ci]; ++bx)
              jobs.insert(jobs.end(), {ci, 64 * ((my * comp_v[ci] + by) * blocks_w[ci] +
                                                 mx * comp_h[ci] + bx)});
        }
  }
  const int64_t n_jobs = static_cast<int64_t>(jobs.size()) / 2;
  const int64_t step = restart ? restart * per_mcu : n_jobs;
  const std::vector<uint8_t> empty;
  for (int64_t s = 0, first = 0; first < n_jobs; ++s, first += step) {
    const std::vector<uint8_t>& data =
        s < static_cast<int64_t>(segments.size()) ? segments[s] : empty;
    const int rc = decode_interval(data, jobs.data() + 2 * first, std::min(step, n_jobs - first),
                                   dc, ac, coefs, n_comp);
    if (rc) return rc;
  }
  return 0;
}

// JPEG (data/jpeg.py::decode_jpeg after its scans): the inverse DCT of
// every component's blocks with its natural-order quantization table
// quant[ci], the fancy upsampling to the largest sampling factors, the
// crop and ycc_rgb_convert (one component: gray in all three channels)
// into uint8 [Y, X, 3].
int hio_jpeg_pixels(int n_comp, const int32_t* const* coefs, const int32_t* const* quant,
                    const int32_t* comp_h, const int32_t* comp_v, const int64_t* blocks_w,
                    int64_t X, int64_t Y, int hmax, int vmax, uint8_t* out) {
  std::vector<std::vector<uint8_t>> planes(n_comp);
  std::vector<uint8_t> plane;
  for (int ci = 0; ci < n_comp; ++ci) {
    const int64_t w = (X * comp_h[ci] + hmax - 1) / hmax, h = (Y * comp_v[ci] + vmax - 1) / vmax;
    const int fh = hmax / comp_h[ci], fv = vmax / comp_v[ci];
    if (fh * w < X || fv * h < Y) return HIO_UNSUPPORTED;
    plane.assign(static_cast<size_t>(w * h), 0);
    for (int64_t by = 0; by * 8 < h; ++by)
      for (int64_t bx = 0; bx * 8 < w; ++bx)
        idct_block(coefs[ci] + 64 * (by * blocks_w[ci] + bx), quant[ci],
                   &plane[by * 8 * w + bx * 8], w,
                   static_cast<int>(std::min<int64_t>(8, h - by * 8)),
                   static_cast<int>(std::min<int64_t>(8, w - bx * 8)));
    const int rc = upsample(plane, h, w, fh, fv, planes[ci]);
    if (rc) return rc;
  }
  for (int ci = 0; ci < n_comp; ++ci) {  // crop to [Y, X] in place
    const int64_t ow = (hmax / comp_h[ci]) * ((X * comp_h[ci] + hmax - 1) / hmax);
    std::vector<uint8_t>& p = planes[ci];
    for (int64_t y = 0; y < Y; ++y) std::memmove(&p[y * X], &p[y * ow], static_cast<size_t>(X));
  }
  if (n_comp == 1) {
    const uint8_t* g = planes[0].data();
    for (int64_t i = 0; i < X * Y; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
    return 0;
  }
  const uint8_t *py = planes[0].data(), *pcb = planes[1].data(), *pcr = planes[2].data();
  constexpr int SCALEBITS = 16;
  constexpr int64_t ONE_HALF = int64_t{1} << 15;
  for (int64_t i = 0; i < X * Y; ++i) {
    const int64_t cb = static_cast<int64_t>(pcb[i]) - 128, cr = static_cast<int64_t>(pcr[i]) - 128;
    const int64_t y = py[i];
    out[3 * i] = clip255(y + ((91881 * cr + ONE_HALF) >> SCALEBITS));
    out[3 * i + 1] = clip255(y + ((-46802 * cr + (-22554 * cb + ONE_HALF)) >> SCALEBITS));
    out[3 * i + 2] = clip255(y + ((116130 * cb + ONE_HALF) >> SCALEBITS));
  }
  return 0;
}

}  // extern "C"
