// Native host image preprocessing: decode (JPEG/PNG/WebP) + PIL-compatible
// bicubic shorter-side resize + center crop, emitting uint8 HWC.
//
// This replaces the reference's torchvision/PIL per-item preprocessing
// (the reference's clip_retrieval/clip_inference/reader.py:101,163) — the
// documented bottleneck of the whole inference pipeline
// (the reference's docs/distributed_clip_inference.md:203-205: A100 nodes ran
// preprocessing-bound, not model-bound).  TPU hosts have many cores but each
// core must decode faster than PIL to keep the MXU fed; this file gives each
// prefetch thread a single C call per image (GIL released by ctypes) and a
// whole-batch OpenMP entry point for bulk use.
//
// Semantics match `models/preprocess.py::decode_resize_center_crop`:
//   shorter side -> target via bicubic (Pillow a=-0.5 kernel, antialias
//   support scaling, horizontal-then-vertical uint8 passes), then center
//   crop.  The resize computes only the pixels that survive the crop.
//   `fast=1` additionally uses libjpeg DCT scaling (like PIL's Image.draft):
//   decode at the largest 1/1..1/8 scale whose shorter side still >= target.
//
// Return codes: 0 ok, 1 unsupported container (caller falls back to PIL),
// 2 decode error, 3 bad args.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <webp/decode.h>

namespace {

struct Img {
  int w = 0, h = 0;
  std::vector<uint8_t> px;  // RGB, row-major
};

// ---------------------------------------------------------------------------
// decoders
// ---------------------------------------------------------------------------

// PIL's MAX_IMAGE_PIXELS default: reject decompression bombs the same way
// the reference's PIL path did (DecompressionBombError -> sample skipped);
// without a cap a 50000x50000 crawl image allocates GBs per worker thread.
constexpr uint64_t kMaxPixels = 89478485;

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

void jpeg_silent(j_common_ptr) {}  // no stderr chatter from worker threads

bool decode_jpeg(const uint8_t* data, size_t len, int target, bool fast,
                 Img& out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.output_message = jpeg_silent;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    // PIL converts CMYK with its own formula; keep parity via fallback.
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (static_cast<uint64_t>(cinfo.image_width) * cinfo.image_height >
      kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return false;  // PIL fallback raises DecompressionBombError -> skip
  }
  cinfo.out_color_space = JCS_RGB;
  if (fast && target > 0) {
    // Largest downscale in {1, 1/2, 1/4, 1/8} whose shorter side >= target
    // (PIL Image.draft semantics).
    int shorter = std::min(static_cast<int>(cinfo.image_width),
                           static_cast<int>(cinfo.image_height));
    int denom = 1;
    while (denom < 8 && (shorter + 2 * denom - 1) / (2 * denom) >= target)
      denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  out.w = static_cast<int>(cinfo.output_width);
  out.h = static_cast<int>(cinfo.output_height);
  if (out.w <= 0 || out.h <= 0 || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out.px.resize(static_cast<size_t>(out.w) * out.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.px.data() + static_cast<size_t>(cinfo.output_scanline) *
                                       out.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // Corrupt-but-recoverable data (e.g. truncated file) raises warnings and
  // libjpeg pads with gray; PIL raises instead and the reference skips the
  // sample (`reader.py:101-104`).  Fail → PIL fallback → same skip behavior.
  const bool clean = jerr.mgr.num_warnings == 0;
  jpeg_destroy_decompress(&cinfo);
  return clean;
}

bool decode_png(const uint8_t* data, size_t len, Img& out) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return false;
  if (static_cast<uint64_t>(image.width) * image.height > kMaxPixels) {
    png_image_free(&image);
    return false;  // decompression-bomb cap (see kMaxPixels)
  }
  // Read RGBA then drop alpha: PIL's convert("RGB") drops the channel
  // without compositing, and this also normalizes palette/gray/16-bit.
  image.format = PNG_FORMAT_RGBA;
  std::vector<uint8_t> rgba(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, rgba.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  out.w = static_cast<int>(image.width);
  out.h = static_cast<int>(image.height);
  out.px.resize(static_cast<size_t>(out.w) * out.h * 3);
  const uint8_t* s = rgba.data();
  uint8_t* d = out.px.data();
  for (size_t i = 0, n = static_cast<size_t>(out.w) * out.h; i < n; ++i) {
    d[0] = s[0];
    d[1] = s[1];
    d[2] = s[2];
    d += 3;
    s += 4;
  }
  return true;
}

bool decode_webp(const uint8_t* data, size_t len, Img& out) {
  int w = 0, h = 0;
  if (!WebPGetInfo(data, len, &w, &h)) return false;
  if (static_cast<uint64_t>(w) * h > kMaxPixels) return false;
  uint8_t* rgba = WebPDecodeRGBA(data, len, &w, &h);
  if (!rgba) return false;
  out.w = w;
  out.h = h;
  out.px.resize(static_cast<size_t>(w) * h * 3);
  const uint8_t* s = rgba;
  uint8_t* d = out.px.data();
  for (size_t i = 0, n = static_cast<size_t>(w) * h; i < n; ++i) {
    d[0] = s[0];
    d[1] = s[1];
    d[2] = s[2];
    d += 3;
    s += 4;
  }
  WebPFree(rgba);
  return true;
}

// ---------------------------------------------------------------------------
// Pillow-compatible bicubic resample (a = -0.5, antialias support scaling)
// ---------------------------------------------------------------------------

double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  std::vector<int> lo;       // first input index per output pixel
  std::vector<int> count;    // taps per output pixel
  std::vector<double> w;     // flattened weights, stride = max taps
  int stride = 0;
};

// Weights for output pixels [out_lo, out_hi) of a full resize in_size ->
// out_size (Pillow ImagingPrecomputeCoeffs, box = whole image).
Coeffs make_coeffs(int in_size, int out_size, int out_lo, int out_hi) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  const int max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  const int n = out_hi - out_lo;
  c.lo.resize(n);
  c.count.resize(n);
  c.stride = max_taps;
  c.w.assign(static_cast<size_t>(n) * max_taps, 0.0);
  for (int i = 0; i < n; ++i) {
    const double center = (out_lo + i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    double sum = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double wj = bicubic((j - center + 0.5) / filterscale);
      c.w[static_cast<size_t>(i) * max_taps + (j - lo)] = wj;
      sum += wj;
    }
    if (sum != 0.0)
      for (int j = 0; j < hi - lo; ++j)
        c.w[static_cast<size_t>(i) * max_taps + j] /= sum;
    c.lo[i] = lo;
    c.count[i] = hi - lo;
  }
  return c;
}

inline uint8_t clamp8(double v) {
  const double r = std::nearbyint(v);
  return r <= 0.0 ? 0 : (r >= 255.0 ? 255 : static_cast<uint8_t>(r));
}

// shorter-side resize to `target` + center crop, computing only surviving
// pixels.  Horizontal pass to a uint8 intermediate then vertical pass,
// mirroring Pillow's two-pass uint8 pipeline.
void resize_crop(const Img& in, int target, uint8_t* out) {
  // round-half-even to mirror Python round() in decode_resize_center_crop
  int nw, nh;
  if (in.w < in.h) {
    nw = target;
    nh = std::max(
        target, static_cast<int>(std::nearbyint(
                    static_cast<double>(in.h) * target / in.w)));
  } else {
    nh = target;
    nw = std::max(
        target, static_cast<int>(std::nearbyint(
                    static_cast<double>(in.w) * target / in.h)));
  }
  const int left = (nw - target) / 2;
  const int top = (nh - target) / 2;

  if (in.w == nw && in.h == nh) {  // no resize, pure crop
    for (int y = 0; y < target; ++y)
      std::memcpy(out + static_cast<size_t>(y) * target * 3,
                  in.px.data() +
                      (static_cast<size_t>(y + top) * in.w + left) * 3,
                  static_cast<size_t>(target) * 3);
    return;
  }

  const Coeffs cx = make_coeffs(in.w, nw, left, left + target);
  const Coeffs cy = make_coeffs(in.h, nh, top, top + target);

  // horizontal: in.h rows x target cols — but only rows the vertical pass
  // reads ([row_lo, row_hi))
  int row_lo = in.h, row_hi = 0;
  for (int i = 0; i < target; ++i) {
    row_lo = std::min(row_lo, cy.lo[i]);
    row_hi = std::max(row_hi, cy.lo[i] + cy.count[i]);
  }
  const int rows = row_hi - row_lo;
  std::vector<uint8_t> tmp(static_cast<size_t>(rows) * target * 3);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src =
        in.px.data() + static_cast<size_t>(y + row_lo) * in.w * 3;
    uint8_t* dst = tmp.data() + static_cast<size_t>(y) * target * 3;
    for (int x = 0; x < target; ++x) {
      const double* w = &cx.w[static_cast<size_t>(x) * cx.stride];
      const int lo = cx.lo[x], cnt = cx.count[x];
      double r = 0, g = 0, b = 0;
      for (int j = 0; j < cnt; ++j) {
        const uint8_t* p = src + static_cast<size_t>(lo + j) * 3;
        r += w[j] * p[0];
        g += w[j] * p[1];
        b += w[j] * p[2];
      }
      dst[x * 3 + 0] = clamp8(r);
      dst[x * 3 + 1] = clamp8(g);
      dst[x * 3 + 2] = clamp8(b);
    }
  }

  // vertical over the intermediate
  for (int y = 0; y < target; ++y) {
    const double* w = &cy.w[static_cast<size_t>(y) * cy.stride];
    const int lo = cy.lo[y] - row_lo, cnt = cy.count[y];
    uint8_t* dst = out + static_cast<size_t>(y) * target * 3;
    for (int x = 0; x < target * 3; ++x) {
      double acc = 0;
      for (int j = 0; j < cnt; ++j)
        acc += w[j] * tmp[static_cast<size_t>(lo + j) * target * 3 + x];
      dst[x] = clamp8(acc);
    }
  }
}

bool decode_any(const uint8_t* data, int64_t len, int target, bool fast,
                Img& img, int32_t& rc) {
  if (len < 12 || !data || target <= 0) {
    rc = 3;
    return false;
  }
  const size_t n = static_cast<size_t>(len);
  if (data[0] == 0xFF && data[1] == 0xD8) {
    if (!decode_jpeg(data, n, target, fast, img)) {
      rc = 2;
      return false;
    }
  } else if (data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' &&
             data[3] == 'G') {
    if (!decode_png(data, n, img)) {
      rc = 2;
      return false;
    }
  } else if (std::memcmp(data, "RIFF", 4) == 0 &&
             std::memcmp(data + 8, "WEBP", 4) == 0) {
    if (!decode_webp(data, n, img)) {
      rc = 2;
      return false;
    }
  } else {
    rc = 1;  // bmp/tiff/gif etc.: PIL fallback
    return false;
  }
  if (img.w <= 0 || img.h <= 0) {
    rc = 2;
    return false;
  }
  rc = 0;
  return true;
}

}  // namespace

extern "C" {

int32_t crt_decode_resize_crop(const uint8_t* data, int64_t len,
                               int32_t target, int32_t fast, uint8_t* out) {
  // exception barrier: nothing may escape the extern "C"/ctypes boundary
  // (a bad_alloc unwinding through an OpenMP region would terminate the
  // whole Python process instead of skipping one corrupt sample)
  try {
    Img img;
    int32_t rc = 0;
    if (!decode_any(data, len, target, fast != 0, img, rc)) return rc;
    resize_crop(img, target, out);
    return 0;
  } catch (...) {
    return 3;  // decode failure -> PIL fallback / sample skip
  }
}

// blob-packed batch: item i is blob[offsets[i]:offsets[i+1]].  out is
// (n, target, target, 3) uint8; ok[i] gets the per-item return code.
void crt_decode_batch(const uint8_t* blob, const int64_t* offsets, int32_t n,
                      int32_t target, int32_t fast, uint8_t* out,
                      int32_t* ok) {
  const size_t item = static_cast<size_t>(target) * target * 3;
#pragma omp parallel for schedule(dynamic)
  for (int32_t i = 0; i < n; ++i) {
    ok[i] = crt_decode_resize_crop(blob + offsets[i],
                                   offsets[i + 1] - offsets[i], target, fast,
                                   out + static_cast<size_t>(i) * item);
  }
}

}  // extern "C"
