// Host data-path ops of the PyTorch port: PNG decode written over zlib's
// inflate (no libpng), LUT remap of labels, caffe normalization of images
// and a Gaussian blur byte-exact against Pillow's. CPython C API only; the
// pixel work runs with the GIL released, so the loader's worker threads
// scale across cores.
//
//   decode_png(bytes, expand_rgb=True) -> (bytes, h, w, channels, bitdepth)
//   decode_remap(bytes, lut_i32)       -> (int32 bytes, h, w)   labels
//   decode_normalize_bgr(bytes, mean)  -> (float32 bytes, h, w) images
//   gaussian_blur(u8, h, w, c, radius) -> uint8 bytes
//
// expand_rgb=True gives what Pillow's Image.open(p).convert("RGB") gives
// for 8-bit RGB(A), gray, gray+alpha and palette files and for 16-bit RGB(A)
// and gray+alpha (the high byte of each sample); 16-bit gray also takes the
// high byte, where Pillow clips the value to 255. expand_rgb=False gives the
// stored samples: 16-bit in host order, sub-8-bit unpacked and unscaled,
// palette files as their indices (as np.asarray(Image.open(p)) reads them).
// Adam7-interlaced files raise ValueError; the datasets read them through
// PIL. Python wrappers: maxsquareloss_torch/data/hostops.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <utility>
#include <vector>

namespace {

constexpr uint32_t kMaxSide = 1000000;  // libpng's default user limit

struct Png {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0;
  int channels = 0;    // samples a pixel as stored
  size_t rowbytes = 0;  // bytes a row, the filter byte excluded
  size_t bpp = 0;       // filter distance: bytes a whole pixel, at least 1
  uint8_t palette[256 * 3] = {0};
  std::vector<uint8_t> raw;  // h rows of (filter byte, rowbytes), unfiltered

  const uint8_t* row(uint32_t y) const { return raw.data() + y * (rowbytes + 1) + 1; }
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int type_channels(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

bool depth_allowed(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
  }
  return false;
}

bool fail(std::string* err, const char* msg) {
  *err = msg;
  return false;
}

bool parse_ihdr(const uint8_t* d, Png* png, std::string* err) {
  png->w = be32(d);
  png->h = be32(d + 4);
  png->depth = d[8];
  png->color = d[9];
  if (png->w == 0 || png->h == 0 || png->w > kMaxSide || png->h > kMaxSide)
    return fail(err, "PNG image size out of range");
  if (!depth_allowed(png->color, png->depth))
    return fail(err, "invalid PNG colour type and bit depth");
  if (d[10] != 0 || d[11] != 0) return fail(err, "unknown PNG compression or filter method");
  if (d[12] == 1) return fail(err, "Adam7-interlaced PNG is not supported");
  if (d[12] != 0) return fail(err, "unknown PNG interlace method");
  png->channels = type_channels(png->color);
  const size_t bits = size_t(png->w) * png->channels * png->depth;
  png->rowbytes = (bits + 7) / 8;
  png->bpp = (size_t(png->channels) * png->depth + 7) / 8;
  return true;
}

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

#if defined(__SSE2__)
// Paeth over 3- or 4-byte pixels, one pixel a step in 16-bit lanes (the
// whole row's dependency runs through the left pixel, so lanes are
// channels): |p-a| = |b-c|, |p-b| = |a-c|, |p-c| = |a+b-2c|, ties to a,
// then b, as in the scalar form.
template <int kBpp>
void paeth_row_sse2(uint8_t* r, const uint8_t* prev, size_t n) {
  const __m128i zero = _mm_setzero_si128();
  auto load = [](const uint8_t* p) {
    uint32_t v = 0;
    std::memcpy(&v, p, kBpp);
    return _mm_unpacklo_epi8(_mm_cvtsi32_si128(int(v)), _mm_setzero_si128());
  };
  auto absv = [&](__m128i x) { return _mm_max_epi16(x, _mm_sub_epi16(zero, x)); };
  auto pick = [](__m128i m, __m128i t, __m128i e) {
    return _mm_or_si128(_mm_and_si128(m, t), _mm_andnot_si128(m, e));
  };
  __m128i a = zero, b = zero, c, d = zero;
  for (size_t i = 0; i + kBpp <= n; i += kBpp) {
    c = b;
    b = load(prev + i);
    a = d;
    d = load(r + i);
    const __m128i pa0 = _mm_sub_epi16(b, c), pb0 = _mm_sub_epi16(a, c);
    const __m128i pa = absv(pa0), pb = absv(pb0), pc = absv(_mm_add_epi16(pa0, pb0));
    const __m128i least = _mm_min_epi16(pc, _mm_min_epi16(pa, pb));
    const __m128i pred = pick(_mm_cmpeq_epi16(least, pa), a,
                              pick(_mm_cmpeq_epi16(least, pb), b, c));
    d = _mm_and_si128(_mm_add_epi16(d, pred), _mm_set1_epi16(0xff));
    const uint32_t v = uint32_t(_mm_cvtsi128_si32(_mm_packus_epi16(d, d)));
    std::memcpy(r + i, &v, kBpp);
  }
}
#endif

// Undo the five row filters in place, row by row.
bool unfilter(Png* png, std::string* err) {
  const size_t n = png->rowbytes, bpp = png->bpp, stride = n + 1;
  const std::vector<uint8_t> zero(n, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < png->h; ++y) {
    uint8_t* line = png->raw.data() + y * stride;
    uint8_t* r = line + 1;
    switch (line[0]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < n; ++i) r[i] = uint8_t(r[i] + r[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < n; ++i) r[i] = uint8_t(r[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < bpp && i < n; ++i) r[i] = uint8_t(r[i] + (prev[i] >> 1));
        for (size_t i = bpp; i < n; ++i)
          r[i] = uint8_t(r[i] + ((unsigned(r[i - bpp]) + prev[i]) >> 1));
        break;
      case 4:
#if defined(__SSE2__)
        if (bpp == 3 || bpp == 4) {
          if (bpp == 3) paeth_row_sse2<3>(r, prev, n);
          else paeth_row_sse2<4>(r, prev, n);
          break;
        }
#endif
        for (size_t i = 0; i < bpp && i < n; ++i) r[i] = uint8_t(r[i] + prev[i]);
        for (size_t i = bpp; i < n; ++i)
          r[i] = uint8_t(r[i] + paeth(r[i - bpp], prev[i], prev[i - bpp]));
        break;
      default:
        return fail(err, "bad PNG row filter type");
    }
    prev = r;
  }
  return true;
}

// Inflate the concatenated IDAT data into png->raw: exactly h rows of
// (1 + rowbytes); compressed data past them is ignored, as libpng does.
bool inflate_idat(const std::vector<std::pair<const uint8_t*, size_t>>& idat, Png* png,
                  std::string* err) {
  png->raw.resize((png->rowbytes + 1) * png->h);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return fail(err, "zlib inflateInit failed");
  uint8_t* out = png->raw.data();
  size_t left = png->raw.size();
  bool ended = false, bad = false;
  for (const auto& piece : idat) {
    const uint8_t* in = piece.first;
    size_t in_left = piece.second;
    while (left > 0 && in_left > 0 && !ended && !bad) {
      const uInt in_n = in_left > (1u << 30) ? (1u << 30) : uInt(in_left);
      const uInt out_n = left > (1u << 30) ? (1u << 30) : uInt(left);
      zs.next_in = const_cast<Bytef*>(in);
      zs.avail_in = in_n;
      zs.next_out = out;
      zs.avail_out = out_n;
      const int ret = inflate(&zs, Z_NO_FLUSH);
      const size_t used = in_n - zs.avail_in, made = out_n - zs.avail_out;
      in += used;
      in_left -= used;
      out += made;
      left -= made;
      if (ret == Z_STREAM_END) ended = true;
      else if (ret == Z_BUF_ERROR && used == 0 && made == 0) break;
      else if (ret != Z_OK && ret != Z_BUF_ERROR) bad = true;
    }
    if (left == 0 || ended || bad) break;
  }
  inflateEnd(&zs);
  if (bad) return fail(err, "corrupt PNG image data (zlib)");
  if (left != 0) return fail(err, "truncated PNG image data");
  return true;
}

// Signature, chunk walk (CRC of every critical chunk), IHDR, PLTE, IDAT
// concatenation up to IEND, inflate and unfilter.
bool read_png(const uint8_t* buf, size_t size, Png* png, std::string* err) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || std::memcmp(buf, kSig, 8) != 0) return fail(err, "not a PNG (bad signature)");
  std::vector<std::pair<const uint8_t*, size_t>> idat;
  bool have_ihdr = false, have_plte = false;
  size_t off = 8;
  for (;;) {
    if (size - off < 12) return fail(err, "truncated PNG: a chunk runs past the end of the data");
    const uint32_t len = be32(buf + off);
    if (len > 0x7fffffffu) return fail(err, "bad PNG chunk length");
    if (size - off - 12 < len) return fail(err, "truncated PNG: a chunk runs past the end of the data");
    const uint8_t* type = buf + off + 4;
    const uint8_t* data = type + 4;
    if ((type[0] & 0x20) == 0) {  // critical chunk: its CRC must hold
      uLong crc = crc32(0L, type, 4);
      crc = crc32(crc, data, len);
      if (uint32_t(crc) != be32(data + len)) return fail(err, "PNG CRC error in a critical chunk");
    }
    off += 12 + size_t(len);
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_ihdr || len != 13) return fail(err, "bad PNG IHDR chunk");
      if (!parse_ihdr(data, png, err)) return false;
      have_ihdr = true;
      continue;
    }
    if (!have_ihdr) return fail(err, "PNG does not start with IHDR");
    if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len == 0 || len % 3 != 0 || len > 768) return fail(err, "bad PNG PLTE chunk");
      std::memcpy(png->palette, data, len);
      have_plte = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.emplace_back(data, len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if ((type[0] & 0x20) == 0) {
      return fail(err, "unknown critical PNG chunk");
    }  // ancillary chunks (tRNS, gAMA, text, ...) do not change the samples
  }
  if (png->color == 3 && !have_plte) return fail(err, "palette PNG without PLTE");
  if (idat.empty()) return fail(err, "PNG without IDAT");
  if (!inflate_idat(idat, png, err)) return false;
  return unfilter(png, err);
}

// read_png that turns an allocation failure into an error (it runs with the
// GIL released, where an exception must not escape).
bool read_png_safe(const uint8_t* buf, size_t size, Png* png, std::string* err) {
  try {
    return read_png(buf, size, png, err);
  } catch (const std::exception& e) {
    *err = std::string("PNG decode failed: ") + e.what();
    return false;
  }
}

inline unsigned unpack(const uint8_t* r, uint32_t x, int depth) {
  const size_t bit = size_t(x) * depth;
  return (r[bit >> 3] >> (8 - depth - int(bit & 7))) & ((1u << depth) - 1);
}

// One row as 8-bit RGB: palette looked up, gray replicated, alpha dropped,
// 16-bit samples' high byte, sub-8-bit gray scaled to 0..255.
void rgb_row(const Png& png, uint32_t y, uint8_t* o) {
  const uint8_t* r = png.row(y);
  const uint32_t w = png.w;
  if (png.color == 3) {
    for (uint32_t x = 0; x < w; ++x) {
      const unsigned i = png.depth == 8 ? r[x] : unpack(r, x, png.depth);
      std::memcpy(o + 3 * size_t(x), png.palette + 3 * i, 3);
    }
    return;
  }
  if (png.depth < 8) {  // gray at 1, 2 or 4 bits
    const unsigned scale = 255u / ((1u << png.depth) - 1);
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t v = uint8_t(unpack(r, x, png.depth) * scale);
      o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = v;
    }
    return;
  }
  if (png.color == 2 && png.depth == 8) {
    std::memcpy(o, r, size_t(w) * 3);
    return;
  }
  const size_t step = png.depth / 8, px = png.channels * step;
  if (png.channels >= 3) {
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* p = r + x * px;
      o[3 * x] = p[0];
      o[3 * x + 1] = p[step];
      o[3 * x + 2] = p[2 * step];
    }
  } else {
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t v = r[x * px];
      o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = v;
    }
  }
}

int stored_channels(const Png& png) { return png.depth < 8 ? 1 : png.channels; }

// One row of stored samples: 16-bit in host order, sub-8-bit unpacked.
void stored_row(const Png& png, uint32_t y, uint8_t* o) {
  const uint8_t* r = png.row(y);
  if (png.depth == 8) {
    std::memcpy(o, r, png.rowbytes);
  } else if (png.depth == 16) {
    uint16_t* o16 = reinterpret_cast<uint16_t*>(o);
    const size_t n = size_t(png.w) * png.channels;
    for (size_t i = 0; i < n; ++i) o16[i] = uint16_t((r[2 * i] << 8) | r[2 * i + 1]);
  } else {
    for (uint32_t x = 0; x < png.w; ++x) o[x] = uint8_t(unpack(r, x, png.depth));
  }
}

// The first stored sample of each pixel (a label's id) through the LUT.
void remap_row(const Png& png, uint32_t y, const int32_t* lut, int64_t lut_n, int32_t* o) {
  const uint8_t* r = png.row(y);
  const uint32_t w = png.w;
  auto look = [&](int64_t v) { return lut[v < lut_n ? v : lut_n - 1]; };
  if (png.depth == 8) {
    const size_t c = png.channels;
    for (uint32_t x = 0; x < w; ++x) o[x] = look(r[x * c]);
  } else if (png.depth == 16) {
    const size_t px = 2 * size_t(png.channels);
    for (uint32_t x = 0; x < w; ++x) o[x] = look((int64_t(r[x * px]) << 8) | r[x * px + 1]);
  } else {
    for (uint32_t x = 0; x < w; ++x) o[x] = look(unpack(r, x, png.depth));
  }
}

PyObject* decode_error(const std::string& err) {
  PyErr_SetString(PyExc_ValueError, err.c_str());
  return nullptr;
}

// Parse and inflate with the GIL released; the caller owns `view`.
bool read_view(const Py_buffer& view, Png* png, std::string* err) {
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = read_png_safe(static_cast<const uint8_t*>(view.buf), size_t(view.len), png, err);
  Py_END_ALLOW_THREADS;
  return ok;
}

PyObject* py_decode_png(PyObject*, PyObject* args) {
  Py_buffer view;
  int expand_rgb = 1;
  if (!PyArg_ParseTuple(args, "y*|p", &view, &expand_rgb)) return nullptr;
  Png png;
  std::string err;
  const bool ok = read_view(view, &png, &err);
  PyBuffer_Release(&view);
  if (!ok) return decode_error(err);
  const int c = expand_rgb ? 3 : stored_channels(png);
  const int bytes_per = (!expand_rgb && png.depth == 16) ? 2 : 1;
  const size_t row = size_t(png.w) * c * bytes_per;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(row * png.h));
  if (!out) return nullptr;
  uint8_t* o = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  Py_BEGIN_ALLOW_THREADS;
  for (uint32_t y = 0; y < png.h; ++y) {
    if (expand_rgb) rgb_row(png, y, o + y * row);
    else stored_row(png, y, o + y * row);
  }
  Py_END_ALLOW_THREADS;
  return Py_BuildValue("(Niiii)", out, int(png.h), int(png.w), c, 8 * bytes_per);
}

// Fused: label PNG (its first stored sample) + int32 LUT → int32 ids;
// ids past the LUT take its last entry (numpy's clip in mask_transform).
PyObject* py_decode_remap(PyObject*, PyObject* args) {
  Py_buffer view, lut_view;
  if (!PyArg_ParseTuple(args, "y*y*", &view, &lut_view)) return nullptr;
  if (lut_view.len % 4 != 0 || lut_view.len == 0) {
    PyBuffer_Release(&view);
    PyBuffer_Release(&lut_view);
    PyErr_SetString(PyExc_ValueError, "lut must be int32 bytes");
    return nullptr;
  }
  Png png;
  std::string err;
  const bool ok = read_view(view, &png, &err);
  PyBuffer_Release(&view);
  if (!ok) {
    PyBuffer_Release(&lut_view);
    return decode_error(err);
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(size_t(png.w) * png.h * 4));
  if (!out) {
    PyBuffer_Release(&lut_view);
    return nullptr;
  }
  int32_t* o = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(out));
  const int32_t* lut = static_cast<const int32_t*>(lut_view.buf);
  const int64_t lut_n = lut_view.len / 4;
  Py_BEGIN_ALLOW_THREADS;
  for (uint32_t y = 0; y < png.h; ++y) remap_row(png, y, lut, lut_n, o + size_t(y) * png.w);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&lut_view);
  return Py_BuildValue("(Nii)", out, int(png.h), int(png.w));
}

// Fused: image PNG → RGB → BGR − mean (caffe normalization) → float32.
PyObject* py_decode_normalize_bgr(PyObject*, PyObject* args) {
  Py_buffer view;
  float m0, m1, m2;  // BGR means
  if (!PyArg_ParseTuple(args, "y*fff", &view, &m0, &m1, &m2)) return nullptr;
  Png png;
  std::string err;
  const bool ok = read_view(view, &png, &err);
  PyBuffer_Release(&view);
  if (!ok) return decode_error(err);
  const size_t row = size_t(png.w) * 3;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(row * png.h * 4));
  if (!out) return nullptr;
  float* o = reinterpret_cast<float*>(PyBytes_AS_STRING(out));
  bool alloc_ok = true;
  Py_BEGIN_ALLOW_THREADS;
  try {
    std::vector<uint8_t> rgb(row);
    for (uint32_t y = 0; y < png.h; ++y) {
      rgb_row(png, y, rgb.data());
      float* p = o + y * row;
      for (size_t x = 0; x < row; x += 3) {
        const float r = rgb[x], g = rgb[x + 1], b = rgb[x + 2];
        p[x] = b - m0;
        p[x + 1] = g - m1;
        p[x + 2] = r - m2;
      }
    }
  } catch (const std::exception&) {
    alloc_ok = false;
  }
  Py_END_ALLOW_THREADS;
  if (!alloc_ok) {
    Py_DECREF(out);
    return PyErr_NoMemory();
  }
  return Py_BuildValue("(Nii)", out, int(png.h), int(png.w));
}

// ---------------------------------------------------------------------------
// Gaussian blur, byte-exact against Pillow's ImageFilter.GaussianBlur.
//
// Pillow blurs with extended box filters (Gwosdek et al., SSVM 2011): the
// radius gives one fractional box radius R = l + a, applied 3 times along
// the rows, then 3 times along the columns, each pass rounding to uint8
// through 8.24 fixed point. The float/double mixing below is Pillow's C
// expressions' (float locals, double literals promote).

float gaussian_box_radius(float radius, int passes) {
  float sigma2 = radius * radius / passes;
  float L = std::sqrt(12.0 * sigma2 + 1.0);  // double expression, float result
  float l = std::floor((L - 1.0) / 2.0);     // double expression, float result
  float a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
  a /= 6 * (sigma2 - (l + 1) * (l + 1));
  return l + a;
}

inline uint8_t box_round(uint32_t acc) { return static_cast<uint8_t>((acc + (1u << 23)) >> 24); }

// One horizontal box pass: edge columns clamp to the border; the interior
// loop is branchless over the interleaved row (d == 0, the whole training
// radius range below sigma 1.17, has a 3-tap form).
void blur_pass_h(const uint8_t* in, uint8_t* out, int h, int w, int c, int d, uint32_t ww,
                 uint32_t fw) {
  const int64_t row = static_cast<int64_t>(w) * c;
  const int lo = d + 1, hi = w - d - 2;  // interior: every tap in bounds
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = in + y * row;
    uint8_t* o = out + y * row;
    auto clamped = [&](int x) {
      for (int ch = 0; ch < c; ++ch) {
        uint32_t S = 0;
        for (int k = -d; k <= d; ++k) {
          int xx = x + k;
          xx = xx < 0 ? 0 : (xx >= w ? w - 1 : xx);
          S += r[xx * c + ch];
        }
        int xl = x - d - 1, xh = x + d + 1;
        xl = xl < 0 ? 0 : xl;
        xh = xh >= w ? w - 1 : xh;
        const uint32_t acc =
            ww * S + fw * (static_cast<uint32_t>(r[xl * c + ch]) + r[xh * c + ch]);
        o[x * c + ch] = box_round(acc);
      }
    };
    const int edge_lo = lo < w ? lo : w;
    for (int x = 0; x < edge_lo; ++x) clamped(x);
    for (int x = (hi + 1 > lo ? hi + 1 : lo); x < w; ++x) clamped(x);
    if (hi >= lo) {
      const int64_t i0 = static_cast<int64_t>(lo) * c;
      const int64_t i1 = static_cast<int64_t>(hi + 1) * c;
      if (d == 0) {
        for (int64_t i = i0; i < i1; ++i) {
          o[i] = box_round(ww * r[i] + fw * (static_cast<uint32_t>(r[i - c]) + r[i + c]));
        }
      } else {
        const int64_t dc = static_cast<int64_t>(d) * c;
        for (int64_t i = i0; i < i1; ++i) {
          uint32_t S = 0;
          for (int64_t k = i - dc; k <= i + dc; k += c) S += r[k];
          o[i] = box_round(ww * S +
                           fw * (static_cast<uint32_t>(r[i - dc - c]) + r[i + dc + c]));
        }
      }
    }
  }
}

// One vertical box pass over whole contiguous rows.
void blur_pass_v(const uint8_t* in, uint8_t* out, int h, int w, int c, int d, uint32_t ww,
                 uint32_t fw) {
  const int64_t row = static_cast<int64_t>(w) * c;
  std::vector<const uint8_t*> taps(2 * d + 1);
  auto rp = [&](int y) {
    y = y < 0 ? 0 : (y >= h ? h - 1 : y);
    return in + static_cast<int64_t>(y) * row;
  };
  for (int y = 0; y < h; ++y) {
    uint8_t* o = out + static_cast<int64_t>(y) * row;
    const uint8_t* elo = rp(y - d - 1);
    const uint8_t* ehi = rp(y + d + 1);
    if (d == 0) {
      const uint8_t* cur = rp(y);
      for (int64_t i = 0; i < row; ++i) {
        o[i] = box_round(ww * cur[i] + fw * (static_cast<uint32_t>(elo[i]) + ehi[i]));
      }
    } else {
      for (int k = 0; k < 2 * d + 1; ++k) taps[k] = rp(y + k - d);
      for (int64_t i = 0; i < row; ++i) {
        uint32_t S = 0;
        for (int k = 0; k < 2 * d + 1; ++k) S += taps[k][i];
        o[i] = box_round(ww * S + fw * (static_cast<uint32_t>(elo[i]) + ehi[i]));
      }
    }
  }
}

// 3 horizontal then 3 vertical passes (Pillow's order), ping-ponging with a
// scratch buffer so the result lands back in `data`.
void gaussian_blur_u8(uint8_t* data, int h, int w, int c, float radius, int passes) {
  const float R = gaussian_box_radius(radius, passes);
  const int d = static_cast<int>(R);
  const uint32_t ww = static_cast<uint32_t>((1 << 24) / (R * 2 + 1));
  const uint32_t fw = ((1u << 24) - (d * 2 + 1) * ww) / 2;
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * w * c);
  uint8_t* a = data;
  uint8_t* b = tmp.data();
  for (int p = 0; p < passes; ++p) {
    blur_pass_h(a, b, h, w, c, d, ww, fw);
    std::swap(a, b);
  }
  for (int p = 0; p < passes; ++p) {
    blur_pass_v(a, b, h, w, c, d, ww, fw);
    std::swap(a, b);
  }
  if (a != data) std::memcpy(data, a, tmp.size());
}

// gaussian_blur(data_u8, h, w, c, radius) -> blurred uint8 bytes.
PyObject* py_gaussian_blur(PyObject*, PyObject* args) {
  Py_buffer view;
  int h, w, c;
  float radius;
  if (!PyArg_ParseTuple(args, "y*iiif", &view, &h, &w, &c, &radius)) return nullptr;
  if (h < 1 || w < 1 || c < 1 || static_cast<int64_t>(h) * w * c != view.len) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "buffer size != h*w*c");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(static_cast<const char*>(view.buf), view.len);
  PyBuffer_Release(&view);
  if (!out) return nullptr;
  uint8_t* o = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  bool alloc_ok = true;
  Py_BEGIN_ALLOW_THREADS;
  if (radius != 0.0f) {  // Pillow returns an untouched copy at radius 0
    try {
      gaussian_blur_u8(o, h, w, c, radius, 3);
    } catch (const std::exception&) {
      alloc_ok = false;
    }
  }
  Py_END_ALLOW_THREADS;
  if (!alloc_ok) {
    Py_DECREF(out);
    return PyErr_NoMemory();
  }
  return out;
}

PyMethodDef kMethods[] = {
    {"decode_png", py_decode_png, METH_VARARGS,
     "decode_png(data, expand_rgb=True) -> (bytes, h, w, channels, bitdepth)"},
    {"decode_remap", py_decode_remap, METH_VARARGS,
     "decode_remap(data, lut_i32_bytes) -> (int32 bytes, h, w)"},
    {"decode_normalize_bgr", py_decode_normalize_bgr, METH_VARARGS,
     "decode_normalize_bgr(data, b_mean, g_mean, r_mean) -> (f32 bytes, h, w)"},
    {"gaussian_blur", py_gaussian_blur, METH_VARARGS,
     "gaussian_blur(data_u8, h, w, c, radius) -> uint8 bytes (byte-exact PIL GaussianBlur)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_msl_hostops",
    "PNG decode over zlib, label remap, caffe normalization and Gaussian blur.",
    -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__msl_hostops(void) { return PyModule_Create(&kModule); }
