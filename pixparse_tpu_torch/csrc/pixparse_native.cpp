// pixparse_tpu native data-plane kernels.
//
// The reference delegates its input-pipeline hot path to native code it does
// not own: torch DataLoader worker processes + PIL/cv2 C decode/resize
// (SURVEY.md §2b, rows "PyTorch ATen", "PIL / OpenCV"). This library is the
// first-party equivalent for the TPU stack's per-host loader:
//
//  - JPEG decode via libjpeg with DCT-domain scaling (decode_jpeg):
//    document scans are typically 1700-3400 px tall while model input is
//    576-798 px, so decoding directly at 1/2..1/8 scale skips most of the
//    IDCT + color work — the single biggest host-CPU win available.
//  - PNG decode via libpng (decode_png), grayscale/RGB output.
//  - Bilinear resize on uint8 (resize_bilinear_u8), separable weights,
//    single pass, no Python-object overhead.
//  - Fused resize+pad+normalize to float32 (resize_pad_normalize_f32):
//    writes the network-ready (H, W, C) float tensor in one pass.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// All functions return 0 on success, negative on failure.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Probe the decoded size for (buf, scale_denom, want_gray).
// Returns 0 and fills out_h/out_w/out_c, or <0 on error.
int jpeg_probe(const uint8_t* buf, int64_t len, int scale_denom, int want_gray,
               int* out_h, int* out_w, int* out_c) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
  if (want_gray) {
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else {
    // force RGB: grayscale sources would return 1 channel and CMYK 4,
    // mismatching the PNG/PIL paths (always 3 for RGB requests)
    cinfo.out_color_space = JCS_RGB;
  }
  jpeg_calc_output_dimensions(&cinfo);
  *out_h = static_cast<int>(cinfo.output_height);
  *out_w = static_cast<int>(cinfo.output_width);
  *out_c = cinfo.out_color_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into caller-allocated out (h*w*c from jpeg_probe with same args).
int jpeg_decode(const uint8_t* buf, int64_t len, int scale_denom, int want_gray,
                uint8_t* out, int out_h, int out_w, int out_c) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
  if (want_gray) {
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else {
    // force RGB: grayscale sources would return 1 channel and CMYK 4,
    // mismatching the PNG/PIL paths (always 3 for RGB requests)
    cinfo.out_color_space = JCS_RGB;
  }
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w ||
      cinfo.out_color_components != out_c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  const int stride = out_w * out_c;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

static void png_read_fn(png_structp png, png_bytep out, png_size_t count) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + count > s->len) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, s->data + s->pos, count);
  s->pos += count;
}

int png_probe(const uint8_t* buf, int64_t len, int want_gray,
              int* out_h, int* out_w, int* out_c) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return -1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return -2; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  PngReadState state{buf, static_cast<size_t>(len), 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);
  *out_h = static_cast<int>(png_get_image_height(png, info));
  *out_w = static_cast<int>(png_get_image_width(png, info));
  *out_c = want_gray ? 1 : 3;
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int png_decode(const uint8_t* buf, int64_t len, int want_gray,
               uint8_t* out, int out_h, int out_w, int out_c) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return -1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return -2; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  PngReadState state{buf, static_cast<size_t>(len), 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  const int bit_depth = png_get_bit_depth(png, info);
  const int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (want_gray) {
    if (color_type & PNG_COLOR_MASK_COLOR) png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  } else {
    if (!(color_type & PNG_COLOR_MASK_COLOR)) png_set_gray_to_rgb(png);
  }
  png_read_update_info(png, info);

  const int h = static_cast<int>(png_get_image_height(png, info));
  const int w = static_cast<int>(png_get_image_width(png, info));
  const int c = static_cast<int>(png_get_channels(png, info));
  if (h != out_h || w != out_w || c != out_c) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  std::vector<png_bytep> rows(h);
  const size_t stride = static_cast<size_t>(w) * c;
  for (int y = 0; y < h; ++y) rows[y] = out + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------------------
// resize / normalize
// ---------------------------------------------------------------------------

// Separable antialiased triangle-filter resize (PIL BILINEAR semantics:
// filter support scales with the downscale factor, half-pixel centers).
// Two passes: horizontal into a float buffer, then vertical.

struct FilterTaps {
  std::vector<int> start;       // first source index per output pixel
  std::vector<int> count;       // taps per output pixel
  std::vector<float> weights;   // concatenated, normalized
  int max_taps = 0;
};

static FilterTaps build_taps(int src_size, int dst_size) {
  FilterTaps t;
  const double scale = static_cast<double>(src_size) / dst_size;
  const double support = scale < 1.0 ? 1.0 : scale;  // triangle radius
  t.start.resize(dst_size);
  t.count.resize(dst_size);
  std::vector<float> w;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  for (int i = 0; i < dst_size; ++i) {
    // PIL ImagingResample window math (half-open, +0.5-shifted bounds)
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    int hi = static_cast<int>(std::floor(center + support + 0.5));
    lo = std::max(lo, 0);
    hi = std::min(hi, src_size);
    if (hi <= lo) { lo = std::min(std::max(0, lo), src_size - 1); hi = lo + 1; }
    t.start[i] = lo;
    t.count[i] = hi - lo;
    t.max_taps = std::max(t.max_taps, hi - lo);
    double total = 0.0;
    size_t base = w.size();
    for (int j = lo; j < hi; ++j) {
      const double d = (j - center + 0.5) / filterscale;
      const double ad = d < 0 ? -d : d;
      const double cw = ad < 1.0 ? 1.0 - ad : 0.0;  // triangle
      w.push_back(static_cast<float>(cw));
      total += cw;
    }
    if (total > 0) {
      for (int j = 0; j < hi - lo; ++j) w[base + j] /= static_cast<float>(total);
    } else {
      for (int j = 0; j < hi - lo; ++j) w[base + j] = 1.0f / (hi - lo);
    }
  }
  t.weights = std::move(w);
  return t;
}

int resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || c <= 0) return -1;
  FilterTaps tx = build_taps(sw, dw);
  FilterTaps ty = build_taps(sh, dh);

  // horizontal pass: (sh, sw, c) -> (sh, dw, c) float
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * c);
  {
    size_t woff_base = 0;
    std::vector<size_t> woffs(dw);
    for (int x = 0; x < dw; ++x) { woffs[x] = woff_base; woff_base += tx.count[x]; }
    for (int y = 0; y < sh; ++y) {
      const uint8_t* srow = src + static_cast<size_t>(y) * sw * c;
      float* trow = tmp.data() + static_cast<size_t>(y) * dw * c;
      for (int x = 0; x < dw; ++x) {
        const float* wts = tx.weights.data() + woffs[x];
        const int s0 = tx.start[x], n = tx.count[x];
        for (int ch = 0; ch < c; ++ch) {
          float acc = 0.0f;
          for (int j = 0; j < n; ++j) acc += wts[j] * srow[(s0 + j) * c + ch];
          trow[x * c + ch] = acc;
        }
      }
    }
  }
  // vertical pass: (sh, dw, c) -> (dh, dw, c) uint8
  {
    size_t woff = 0;
    for (int y = 0; y < dh; ++y) {
      const float* wts = ty.weights.data() + woff;
      const int s0 = ty.start[y], n = ty.count[y];
      woff += n;
      uint8_t* drow = dst + static_cast<size_t>(y) * dw * c;
      for (int x = 0; x < dw * c; ++x) {
        float acc = 0.0f;
        for (int j = 0; j < n; ++j)
          acc += wts[j] * tmp[static_cast<size_t>(s0 + j) * dw * c + x];
        drow[x] = static_cast<uint8_t>(std::lround(
            std::max(0.0f, std::min(255.0f, acc))));
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// General antialiased filter resize (PIL ImagingResample BIT-EXACT parity)
// ---------------------------------------------------------------------------
//
// Exactly Pillow's two-pass fixed-point resample (Resample.c): horizontal
// pass first, uint8 intermediate, 22-bit fixed-point coefficients with
// round-half-away conversion, accumulator seeded with the rounding constant,
// clip8 on every stored pixel. Filters: triangle (BILINEAR, support 1) and
// Catmull-Rom a=-0.5 (BICUBIC, support 2), support scaled by the downscale
// factor (antialias). Bit-exactness is the test contract
// (tests/test_native_resize.py); the speed comes from integer accumulation
// (assocative, so gcc vectorizes both passes) and a zero-padded regular
// coefficient layout in the horizontal pass. Used by
// data/transforms.py::resize_keep_ratio — the per-sample host hot op.

static const int kPrecisionBits = 32 - 8 - 2;  // PIL PRECISION_BITS

static inline uint8_t clip8i(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

static double filter_eval(int filter, double x) {
  x = x < 0 ? -x : x;
  if (filter == 1) {  // bicubic, Catmull-Rom a = -0.5 (PIL's constant)
    const double a = -0.5;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
  }
  return x < 1.0 ? 1.0 - x : 0.0;  // triangle / bilinear
}

struct IntTaps {
  std::vector<int> start;      // first source index per output (padded layout)
  std::vector<int32_t> coef;   // dst_size x max_taps, zero-padded
  int max_taps = 0;
};

static IntTaps build_int_taps(int src_size, int dst_size, int filter) {
  IntTaps t;
  const double scale = static_cast<double>(src_size) / dst_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = (filter == 1 ? 2.0 : 1.0) * filterscale;
  std::vector<int> lo_v(dst_size), n_v(dst_size);
  std::vector<double> w;  // concatenated normalized double weights
  std::vector<size_t> off(dst_size);
  for (int i = 0; i < dst_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, src_size);
    if (hi <= lo) { lo = std::min(std::max(0, lo), src_size - 1); hi = lo + 1; }
    lo_v[i] = lo;
    n_v[i] = hi - lo;
    t.max_taps = std::max(t.max_taps, hi - lo);
    off[i] = w.size();
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double cw = filter_eval(filter, (j - center + 0.5) / filterscale);
      w.push_back(cw);
      total += cw;
    }
    if (total != 0.0)
      for (int j = 0; j < hi - lo; ++j) w[off[i] + j] /= total;
  }
  // regular zero-padded layout: every output reads exactly max_taps source
  // pixels starting at t.start[i] (shifted left when the real window sits at
  // the right edge so reads stay in bounds); pad taps carry coefficient 0
  t.start.resize(dst_size);
  t.coef.assign(static_cast<size_t>(dst_size) * t.max_taps, 0);
  const bool padded = t.max_taps <= src_size;
  for (int i = 0; i < dst_size; ++i) {
    int s = lo_v[i];
    int lead = 0;
    if (padded && s + t.max_taps > src_size) {
      lead = s - (src_size - t.max_taps);
      s = src_size - t.max_taps;
    }
    t.start[i] = s;
    for (int j = 0; j < n_v[i]; ++j) {
      const double k = w[off[i] + j];
      // PIL's round-half-away fixed-point conversion
      t.coef[static_cast<size_t>(i) * t.max_taps + lead + j] =
          static_cast<int32_t>(k < 0 ? k * (1 << kPrecisionBits) - 0.5
                                     : k * (1 << kPrecisionBits) + 0.5);
    }
  }
  if (!padded) {
    // degenerate tiny-source case: windows overlap the whole source; store
    // irregular counts via start/coef pairs of width max_taps clamped later
    for (int i = 0; i < dst_size; ++i) t.start[i] = lo_v[i];
    t.coef.assign(static_cast<size_t>(dst_size) * t.max_taps, 0);
    for (int i = 0; i < dst_size; ++i)
      for (int j = 0; j < n_v[i]; ++j) {
        const double k = w[off[i] + j];
        t.coef[static_cast<size_t>(i) * t.max_taps + j] =
            static_cast<int32_t>(k < 0 ? k * (1 << kPrecisionBits) - 0.5
                                       : k * (1 << kPrecisionBits) + 0.5);
      }
  }
  return t;
}

// horizontal resample: (rows, sw, c) u8 -> (rows, dw, c) u8
static void ipass_h(const uint8_t* src, int rows, int sw, int c,
                    const IntTaps& t, int dw, uint8_t* out) {
  const int mt = t.max_taps;
  const bool regular = mt <= sw;
  const int32_t seed = 1 << (kPrecisionBits - 1);
  const int32_t* __restrict__ coef = t.coef.data();
  const int* __restrict__ start = t.start.data();
  for (int y = 0; y < rows; ++y) {
    const uint8_t* __restrict__ srow = src + static_cast<size_t>(y) * sw * c;
    uint8_t* __restrict__ orow = out + static_cast<size_t>(y) * dw * c;
    if (c == 1) {
      for (int x = 0; x < dw; ++x) {
        const int32_t* __restrict__ k = coef + static_cast<size_t>(x) * mt;
        const uint8_t* __restrict__ sp = srow + start[x];
        const int n = regular ? mt : std::min(mt, sw - start[x]);
        int32_t ss = seed;
        for (int j = 0; j < n; ++j) ss += sp[j] * k[j];
        orow[x] = clip8i(ss);
      }
    } else {
      for (int x = 0; x < dw; ++x) {
        const int32_t* __restrict__ k = coef + static_cast<size_t>(x) * mt;
        const uint8_t* __restrict__ sp =
            srow + static_cast<size_t>(start[x]) * c;
        const int n = regular ? mt : std::min(mt, sw - start[x]);
        for (int ch = 0; ch < c; ++ch) {
          int32_t ss = seed;
          for (int j = 0; j < n; ++j) ss += sp[j * c + ch] * k[j];
          orow[x * c + ch] = clip8i(ss);
        }
      }
    }
  }
}

// vertical resample: (sh, row_elems) u8 -> (dh, row_elems) u8, accumulating
// whole rows (contiguous: gcc vectorizes the int32 axpy)
static void ipass_v(const uint8_t* src, int sh, int row_elems,
                    const IntTaps& t, int dh, uint8_t* out,
                    std::vector<int32_t>& acc_v) {
  const int mt = t.max_taps;
  acc_v.resize(row_elems);
  // __restrict__ everywhere: uint8_t loads alias ANY store under the strict
  // aliasing rules (unsigned char), which otherwise blocks the int32-axpy
  // vectorization of the inner loops (measured ~4x on the document shapes)
  int32_t* __restrict__ acc = acc_v.data();
  for (int y = 0; y < dh; ++y) {
    const int32_t* k = t.coef.data() + static_cast<size_t>(y) * mt;
    const int s0 = t.start[y];
    const int n = mt <= sh ? mt : std::min(mt, sh - s0);
    const int32_t seed = 1 << (kPrecisionBits - 1);
    for (int x = 0; x < row_elems; ++x) acc[x] = seed;
    for (int j = 0; j < n; ++j) {
      const uint8_t* __restrict__ srow =
          src + static_cast<size_t>(s0 + j) * row_elems;
      const int32_t kj = k[j];
      if (kj == 0) continue;  // zero padding
      for (int x = 0; x < row_elems; ++x) acc[x] += kj * srow[x];
    }
    uint8_t* __restrict__ orow = out + static_cast<size_t>(y) * row_elems;
    for (int x = 0; x < row_elems; ++x) orow[x] = clip8i(acc[x]);
  }
}

#if defined(__SSE2__)
// 16x16 uint8 block transpose with SSE2 unpack trees: the scalar byte
// transpose moves ~2 GB/s; this moves the resize's two transposes off the
// critical path (measured ~5x at document sizes). Bit-identity is trivial
// (pure data movement).
static inline void transpose16x16_u8(const uint8_t* src, size_t sstride,
                                     uint8_t* dst, size_t dstride) {
  __m128i r[16];
  for (int i = 0; i < 16; ++i)
    r[i] = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(src + i * sstride));
  __m128i t[16];
  for (int i = 0; i < 8; ++i) {
    t[2 * i] = _mm_unpacklo_epi8(r[2 * i], r[2 * i + 1]);
    t[2 * i + 1] = _mm_unpackhi_epi8(r[2 * i], r[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    r[4 * i] = _mm_unpacklo_epi16(t[4 * i], t[4 * i + 2]);
    r[4 * i + 1] = _mm_unpackhi_epi16(t[4 * i], t[4 * i + 2]);
    r[4 * i + 2] = _mm_unpacklo_epi16(t[4 * i + 1], t[4 * i + 3]);
    r[4 * i + 3] = _mm_unpackhi_epi16(t[4 * i + 1], t[4 * i + 3]);
  }
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 4; ++j) {
      t[8 * i + 2 * j] = _mm_unpacklo_epi32(r[8 * i + j], r[8 * i + j + 4]);
      t[8 * i + 2 * j + 1] = _mm_unpackhi_epi32(r[8 * i + j], r[8 * i + j + 4]);
    }
  }
  for (int j = 0; j < 8; ++j) {
    r[2 * j] = _mm_unpacklo_epi64(t[j], t[j + 8]);
    r[2 * j + 1] = _mm_unpackhi_epi64(t[j], t[j + 8]);
  }
  // the three unpack rounds land output row k in r[k] (validated exhaustively
  // against the scalar transpose in the build's unit check)
  for (int k = 0; k < 16; ++k)
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + k * dstride), r[k]);
}
#endif

// cache-blocked uint8 transpose: (h, w) -> (w, h)
static void transpose_u8(const uint8_t* src, int h, int w, uint8_t* dst) {
#if defined(__SSE2__)
  const int hb = h & ~15, wb = w & ~15;
  for (int y0 = 0; y0 < hb; y0 += 16)
    for (int x0 = 0; x0 < wb; x0 += 16)
      transpose16x16_u8(src + static_cast<size_t>(y0) * w + x0, w,
                        dst + static_cast<size_t>(x0) * h + y0, h);
  // edges (right strip and bottom strip): scalar
  for (int y = 0; y < h; ++y)
    for (int x = wb; x < w; ++x)
      dst[static_cast<size_t>(x) * h + y] = src[static_cast<size_t>(y) * w + x];
  for (int y = hb; y < h; ++y)
    for (int x = 0; x < wb; ++x)
      dst[static_cast<size_t>(x) * h + y] = src[static_cast<size_t>(y) * w + x];
#else
  const int B = 64;
  for (int y0 = 0; y0 < h; y0 += B) {
    const int y1 = std::min(h, y0 + B);
    for (int x0 = 0; x0 < w; x0 += B) {
      const int x1 = std::min(w, x0 + B);
      for (int x = x0; x < x1; ++x) {
        uint8_t* drow = dst + static_cast<size_t>(x) * h;
        for (int y = y0; y < y1; ++y)
          drow[y] = src[static_cast<size_t>(y) * w + x];
      }
    }
  }
#endif
}

// filter: 0 = bilinear (triangle), 1 = bicubic (Catmull-Rom a=-0.5).
// Bit-exact with PIL Image.resize for uint8 inputs: identical taps,
// fixed-point coefficients, pass order (horizontal-first), uint8
// intermediate, and clip8 rounding. For 1-channel images the horizontal
// pass runs as transpose -> row-contiguous vertical pass -> transpose —
// the same integer expression per output pixel (so still bit-exact) but
// with an inner loop gcc vectorizes; a direct horizontal pass is scalar
// dot products and measured ~6x slower at document sizes.
int resize_filter_u8(const uint8_t* src, int sh, int sw, int c,
                     uint8_t* dst, int dh, int dw, int filter) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || c <= 0) return -1;
  if (filter != 0 && filter != 1) return -2;
  IntTaps tx = build_int_taps(sw, dw, filter);
  IntTaps ty = build_int_taps(sh, dh, filter);
  // scratch reused across calls (thread_local: loader workers are threads):
  // fresh vectors re-faulted ~3 MB of pages on EVERY per-sample call —
  // measured ~25% of the whole resize at document sizes
  thread_local std::vector<int32_t> acc;
  thread_local std::vector<uint8_t> t1, t2;
  auto grow = [](std::vector<uint8_t>& v, size_t n) {
    if (v.size() < n) v.resize(n);
  };
  if (dw == sw && dh == sh) {
    memcpy(dst, src, static_cast<size_t>(sh) * sw * c);
    return 0;
  }
  if (dw == sw) {  // PIL skips no-op passes; identical here but cheaper
    ipass_v(src, sh, sw * c, ty, dh, dst, acc);
    return 0;
  }
  if (c == 1) {
    // horizontal pass via transpose (see note above)
    grow(t1, std::max(static_cast<size_t>(sw) * sh,
                      static_cast<size_t>(sh) * dw));
    transpose_u8(src, sh, sw, t1.data());               // (sw, sh)
    grow(t2, static_cast<size_t>(dw) * sh);
    ipass_v(t1.data(), sw, sh, tx, dw, t2.data(), acc);  // rows sw -> dw
    if (dh == sh) {
      transpose_u8(t2.data(), dw, sh, dst);              // (sh, dw)
      return 0;
    }
    transpose_u8(t2.data(), dw, sh, t1.data());          // mid (sh, dw)
    ipass_v(t1.data(), sh, dw, ty, dh, dst, acc);
    return 0;
  }
  if (dh == sh) {
    ipass_h(src, sh, sw, c, tx, dw, dst);
    return 0;
  }
  // PIL order: horizontal first through a uint8 intermediate
  grow(t1, static_cast<size_t>(sh) * dw * c);
  ipass_h(src, sh, sw, c, tx, dw, t1.data());
  ipass_v(t1.data(), sh, dw * c, ty, dh, dst, acc);
  return 0;
}

// Fused: bilinear resize of src into the top-left of a (th, tw) canvas filled
// with `fill`, then (x/255 - mean)/std into float32 out (th*tw*c).
int resize_pad_normalize_f32(const uint8_t* src, int sh, int sw, int c,
                             float* out, int th, int tw,
                             int rh, int rw,  // resize target (<= canvas)
                             const float* mean, const float* std_, int fill) {
  if (rh > th || rw > tw) return -1;
  std::vector<uint8_t> resized(static_cast<size_t>(rh) * rw * c);
  int rc = resize_bilinear_u8(src, sh, sw, c, resized.data(), rh, rw);
  if (rc != 0) return rc;
  std::vector<float> inv_std(c), mean_v(c);
  for (int ch = 0; ch < c; ++ch) {
    inv_std[ch] = 1.0f / std_[ch];
    mean_v[ch] = mean[ch];
  }
  const float fillf = static_cast<float>(fill) / 255.0f;
  for (int y = 0; y < th; ++y) {
    float* orow = out + static_cast<size_t>(y) * tw * c;
    if (y < rh) {
      const uint8_t* rrow = resized.data() + static_cast<size_t>(y) * rw * c;
      for (int x = 0; x < rw; ++x)
        for (int ch = 0; ch < c; ++ch)
          orow[x * c + ch] = (rrow[x * c + ch] * (1.0f / 255.0f) - mean_v[ch]) * inv_std[ch];
      for (int x = rw; x < tw; ++x)
        for (int ch = 0; ch < c; ++ch)
          orow[x * c + ch] = (fillf - mean_v[ch]) * inv_std[ch];
    } else {
      for (int x = 0; x < tw; ++x)
        for (int ch = 0; ch < c; ++ch)
          orow[x * c + ch] = (fillf - mean_v[ch]) * inv_std[ch];
    }
  }
  return 0;
}

}  // extern "C"
