// semseg_tpu native host-preprocessing library.
//
// The reference framework's host data path is PIL decode + PIL resize +
// numpy normalize + tensor pad, run in 16 forked worker processes
// (/root/reference/mit_semseg/dataset.py:53-58,172-194, train.py:170-177).
// This library fuses the post-decode stages into single C++ passes that
// release the GIL, so a small thread pool keeps TPU chips fed:
//
//   * ssg_resize_bilinear_u8 — separable triangle-filter resampling with
//     Pillow's fixed-point arithmetic (adaptive kernel support, so
//     downscales are antialiased exactly like Image.resize(BILINEAR));
//     takes a `flip` flag that mirrors the source horizontally DURING the
//     horizontal pass — bit-identical to Image.FLIP_LEFT_RIGHT followed by
//     Image.resize (the triangle filter is symmetric and Pillow's
//     half-pixel-center grid mirrors onto itself), for free: the random
//     train-time flip (reference dataset.py:120-130) otherwise costs a
//     full negative-stride uint8 copy per sample (~11% of host budget);
//   * ssg_resize_nearest_u8  — Pillow NEAREST (affine center sampling),
//     same fused flip;
//   * ssg_normalize_pad      — uint8 -> float32 (x/255 - mean)/std with
//     zero padding to a bucketed canvas;
//   * ssg_preprocess         — resize + normalize + pad in one call;
//   * ssg_jpeg_dims / ssg_decode_jpeg — libjpeg(-turbo) JPEG decode with
//     optional DCT-domain prescale (scale_num/8): decoding at a reduced
//     scale skips most of the IDCT + color conversion work, the classic
//     input-pipeline trick (PIL exposes the same engine as Image.draft).
//     Compiled only where <jpeglib.h> exists; callers must treat a
//     nonzero return as "fall back to PIL".
//
// Exposed as a plain C ABI for ctypes binding (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if defined(SSG_HAVE_JPEG)
#include <jpeglib.h>
#endif

namespace {

// Pillow-compatible fixed-point precision (8-bit data path).
constexpr int kPrecisionBits = 32 - 8 - 2;

struct Filter {
  // For each output index: contribution window [bounds_min, bounds_min+size)
  // and quantized triangle weights.
  std::vector<int> bounds_min;
  std::vector<int> bounds_size;
  std::vector<std::vector<int>> coeffs;
};

inline double triangle(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Precompute the separable resampling filter for one axis, mirroring
// Pillow's adaptive-support algorithm: support scales with the reduction
// factor, weights are normalized in double then quantized to fixed point.
Filter build_filter(int in_size, int out_size) {
  Filter f;
  f.bounds_min.resize(out_size);
  f.bounds_size.resize(out_size);
  f.coeffs.resize(out_size);

  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;

    std::vector<double> w(xmax - xmin);
    double wsum = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      w[x - xmin] = triangle((x - center + 0.5) / filterscale);
      wsum += w[x - xmin];
    }
    std::vector<int> k(w.size());
    for (size_t i = 0; i < w.size(); ++i) {
      const double v = (wsum != 0.0 ? w[i] / wsum : 0.0) * (1 << kPrecisionBits);
      k[i] = static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
    }
    f.bounds_min[xx] = xmin;
    f.bounds_size[xx] = static_cast<int>(w.size());
    f.coeffs[xx] = std::move(k);
  }
  return f;
}

inline uint8_t clip8(int32_t v) {
  // int32 accumulation is safe: triangle weights are non-negative and a
  // pixel's quantized coefficients sum to ~2^22 (kPrecisionBits), so the
  // rounded sum is < 255 * 2^22 + 2^21 < 2^30 regardless of kernel
  // support. (Pillow accumulates in int32 for the same reason; int64 here
  // measurably blocked vectorization.)
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

}  // namespace

extern "C" {

// Bilinear (Pillow-parity) resize of an interleaved uint8 image.
// src: (sh, sw, ch) row-major; dst: (th, tw, ch). `flip` mirrors the
// source horizontally during the horizontal pass (== resizing the
// FLIP_LEFT_RIGHT'd image, bit-exactly — symmetric filter, mirrored grid).
void ssg_resize_bilinear_u8(const uint8_t* src, int sh, int sw, int ch,
                            uint8_t* dst, int th, int tw, int flip) {
  const Filter fh = build_filter(sw, tw);  // horizontal
  const Filter fv = build_filter(sh, th);  // vertical

  // Pass 1: horizontal -> intermediate (sh, tw, ch).
  std::vector<uint8_t> mid(static_cast<size_t>(sh) * tw * ch);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * ch;
    uint8_t* drow = mid.data() + static_cast<size_t>(y) * tw * ch;
    for (int x = 0; x < tw; ++x) {
      const int xmin = fh.bounds_min[x];
      const int n = fh.bounds_size[x];
      const int* k = fh.coeffs[x].data();
      // Source pointer at the window start; mirrored reads walk backwards
      // from the mirrored window start (flip fused into this pass).
      const uint8_t* sp =
          srow + static_cast<size_t>(flip ? sw - 1 - xmin : xmin) * ch;
      const int step = flip ? -ch : ch;
      if (ch == 3) {  // RGB: one window sweep for all three channels
        int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        const uint8_t* p = sp;
        for (int i = 0; i < n; ++i, p += step) {
          const int32_t kc = k[i];
          s0 += static_cast<int32_t>(p[0]) * kc;
          s1 += static_cast<int32_t>(p[1]) * kc;
          s2 += static_cast<int32_t>(p[2]) * kc;
        }
        drow[x * 3 + 0] = clip8(s0);
        drow[x * 3 + 1] = clip8(s1);
        drow[x * 3 + 2] = clip8(s2);
      } else {
        for (int c = 0; c < ch; ++c) {
          int32_t ss = 1 << (kPrecisionBits - 1);
          const uint8_t* p = sp + c;
          for (int i = 0; i < n; ++i, p += step) {
            ss += static_cast<int32_t>(*p) * k[i];
          }
          drow[x * ch + c] = clip8(ss);
        }
      }
    }
  }

  // Pass 2: vertical -> dst (th, tw, ch). Accumulate whole contiguous
  // rows of the intermediate (row-major sweeps vectorize; the previous
  // per-column inner loop strided across rows and was ~2-3x slower).
  const size_t row = static_cast<size_t>(tw) * ch;
  std::vector<int32_t> acc(row);
  for (int y = 0; y < th; ++y) {
    const int ymin = fv.bounds_min[y];
    const int n = fv.bounds_size[y];
    const int* k = fv.coeffs[y].data();
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int i = 0; i < n; ++i) {
      const uint8_t* mrow = mid.data() + static_cast<size_t>(ymin + i) * row;
      const int32_t kc = k[i];
      for (size_t j = 0; j < row; ++j) {
        acc[j] += static_cast<int32_t>(mrow[j]) * kc;
      }
    }
    uint8_t* drow = dst + static_cast<size_t>(y) * row;
    for (size_t j = 0; j < row; ++j) {
      drow[j] = clip8(acc[j]);
    }
  }
}

// Nearest-neighbor resize (Pillow NEAREST affine sampling). `flip`
// samples the horizontally mirrored source (== NEAREST of the flipped
// image: the same sample index read at its mirror position).
//
// Index math replicates Pillow's ImagingScaleAffine BIT-EXACTLY: the
// source coordinate is accumulated iteratively (xo = 0.5*scale; xo +=
// scale per column) — NOT computed as (x + 0.5) * scale, whose different
// fp rounding flips the floor() on exact-integer boundaries for ~1/3 of
// random size pairs (caught by the randomized parity test).
void ssg_resize_nearest_u8(const uint8_t* src, int sh, int sw, int ch,
                           uint8_t* dst, int th, int tw, int flip) {
  const double ys = static_cast<double>(sh) / th;
  const double xs = static_cast<double>(sw) / tw;
  std::vector<int> xintab(tw);
  double xo = xs * 0.5;
  for (int x = 0; x < tw; ++x, xo += xs) {
    int sx = static_cast<int>(xo);
    if (sx >= sw) sx = sw - 1;
    xintab[x] = flip ? sw - 1 - sx : sx;
  }
  double yo = ys * 0.5;
  for (int y = 0; y < th; ++y, yo += ys) {
    int sy = static_cast<int>(yo);
    if (sy >= sh) sy = sh - 1;
    const uint8_t* srow = src + static_cast<size_t>(sy) * sw * ch;
    uint8_t* drow = dst + static_cast<size_t>(y) * tw * ch;
    for (int x = 0; x < tw; ++x) {
      std::memcpy(drow + x * ch, srow + xintab[x] * ch, ch);
    }
  }
}

// uint8 (h, w, 3) -> float32 (ph, pw, 3): (x/255 - mean)/std, zero-padded.
void ssg_normalize_pad(const uint8_t* src, int h, int w, float* dst, int ph,
                       int pw, const float* mean, const float* stdv) {
  const float inv255 = 1.0f / 255.0f;
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = inv255 / stdv[c];
    shift[c] = -mean[c] / stdv[c];
  }
  std::memset(dst, 0, sizeof(float) * static_cast<size_t>(ph) * pw * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * w * 3;
    float* drow = dst + static_cast<size_t>(y) * pw * 3;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        drow[x * 3 + c] = srow[x * 3 + c] * scale[c] + shift[c];
      }
    }
  }
}

// Fused: bilinear resize (sh, sw, 3) -> (th, tw, 3), then normalize into a
// zero-padded float32 canvas (ph, pw, 3). `flip` as in the resizers.
void ssg_preprocess(const uint8_t* src, int sh, int sw, int th, int tw,
                    int ph, int pw, const float* mean, const float* stdv,
                    float* dst, int flip) {
  std::vector<uint8_t> resized(static_cast<size_t>(th) * tw * 3);
  ssg_resize_bilinear_u8(src, sh, sw, 3, resized.data(), th, tw, flip);
  ssg_normalize_pad(resized.data(), th, tw, dst, ph, pw, mean, stdv);
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg / libjpeg-turbo), with DCT-domain prescale.
//
// scale_num selects the decoder's scale_num/8 output scale (1..8; 8 = full
// resolution). Prescaled decode changes the decoded pixels relative to
// full-res-decode-then-resize (it IS a different, cheaper resample), so the
// train pipeline only uses scale_num < 8 behind the opt-in
// cfg.TPU.train_fast_decode; at scale_num == 8 decode is the same libjpeg
// islow path Pillow runs (bindings self-check bit-equality once per process
// before trusting it — see native/__init__.py decode_jpeg_verified).
//
// Returns 0 on success, nonzero on any decode problem (corrupt stream,
// unsupported color space, dimension mismatch) — callers fall back to PIL.

#if defined(SSG_HAVE_JPEG)

namespace {

struct SsgJpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void ssg_jpeg_error_exit(j_common_ptr cinfo) {
  SsgJpegError* err = reinterpret_cast<SsgJpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}

void ssg_jpeg_silence(j_common_ptr, int) {}

// Shared header-parse + scale setup. Returns false on error (after which
// the caller must jpeg_destroy_decompress).
bool ssg_jpeg_setup(jpeg_decompress_struct* cinfo, const uint8_t* data,
                    size_t len, int scale_num) {
  if (scale_num < 1 || scale_num > 8) return false;
  jpeg_mem_src(cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) return false;
  cinfo->scale_num = static_cast<unsigned>(scale_num);
  cinfo->scale_denom = 8;
  // RGB output for the baseline color spaces; anything exotic (CMYK/YCCK)
  // is not worth reimplementing Pillow's conversion for — fall back.
  if (cinfo->jpeg_color_space == JCS_GRAYSCALE ||
      cinfo->jpeg_color_space == JCS_YCbCr ||
      cinfo->jpeg_color_space == JCS_RGB) {
    cinfo->out_color_space = JCS_RGB;
  } else {
    return false;
  }
  jpeg_calc_output_dimensions(cinfo);
  return true;
}

// Decode-path signature from a parsed header: progressive flag, source
// color space, per-component sampling factors (see ssg_jpeg_class).
int ssg_jpeg_sig(const jpeg_decompress_struct& cinfo) {
  int sig = (cinfo.progressive_mode ? 1 : 0) << 20;
  sig |= (static_cast<int>(cinfo.jpeg_color_space) & 0xF) << 16;
  const int n = cinfo.num_components < 4 ? cinfo.num_components : 4;
  for (int c = 0; c < n; ++c) {
    // 1..4 each; pack two 2-bit-ish fields per component (4 bits).
    sig |= ((cinfo.comp_info[c].h_samp_factor & 0x3) |
            ((cinfo.comp_info[c].v_samp_factor & 0x3) << 2))
           << (c * 4);
  }
  return sig;
}

}  // namespace

int ssg_jpeg_dims(const uint8_t* data, size_t len, int scale_num,
                  int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  SsgJpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = ssg_jpeg_error_exit;
  err.mgr.emit_message = ssg_jpeg_silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  const bool ok = ssg_jpeg_setup(&cinfo, data, len, scale_num);
  if (ok) {
    *out_h = static_cast<int>(cinfo.output_height);
    *out_w = static_cast<int>(cinfo.output_width);
  }
  jpeg_destroy_decompress(&cinfo);
  return ok ? 0 : 1;
}

// dst must hold (out_h, out_w, 3) from ssg_jpeg_dims with the same
// (data, len, scale_num).
int ssg_decode_jpeg(const uint8_t* data, size_t len, int scale_num,
                    uint8_t* dst, int dst_h, int dst_w) {
  jpeg_decompress_struct cinfo;
  SsgJpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = ssg_jpeg_error_exit;
  err.mgr.emit_message = ssg_jpeg_silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  bool ok = ssg_jpeg_setup(&cinfo, data, len, scale_num);
  if (ok &&
      (static_cast<int>(cinfo.output_height) != dst_h ||
       static_cast<int>(cinfo.output_width) != dst_w)) {
    ok = false;
  }
  if (ok) {
    jpeg_start_decompress(&cinfo);
    const size_t stride = static_cast<size_t>(cinfo.output_width) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = dst + static_cast<size_t>(cinfo.output_scanline) * stride;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  return ok ? 0 : 1;
}

// Signature of the decode PATH a stream will take: progressive flag,
// source color space, and per-component sampling factors. libjpeg builds
// (Pillow's bundled turbo vs the system library) can differ per-path —
// e.g. merged vs fancy chroma upsampling SIMD only runs for 4:2:0 — so
// bit-equality verified on one class says nothing about another. The
// bindings' decode oracle verifies each distinct signature once
// (native/__init__.py decode_jpeg_verified). Returns -1 on parse error.
int ssg_jpeg_class(const uint8_t* data, size_t len) {
  jpeg_decompress_struct cinfo;
  SsgJpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = ssg_jpeg_error_exit;
  err.mgr.emit_message = ssg_jpeg_silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  int sig = -1;
  if (jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK) {
    sig = ssg_jpeg_sig(cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  return sig;
}

// One-parse metadata: the decode-path signature AND the output dims for
// scale_num/8 — a verified decode then costs ONE header parse up front
// instead of two (class + dims) before the decode's own. Unlike
// ssg_jpeg_class this also applies the decodability checks in
// ssg_jpeg_setup (color space, scale), so -1 means "fall back to PIL".
int ssg_jpeg_meta(const uint8_t* data, size_t len, int scale_num,
                  int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  SsgJpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = ssg_jpeg_error_exit;
  err.mgr.emit_message = ssg_jpeg_silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  int sig = -1;
  if (ssg_jpeg_setup(&cinfo, data, len, scale_num)) {
    sig = ssg_jpeg_sig(cinfo);
    *out_h = static_cast<int>(cinfo.output_height);
    *out_w = static_cast<int>(cinfo.output_width);
  }
  jpeg_destroy_decompress(&cinfo);
  return sig;
}

int ssg_has_jpeg() { return 1; }

#else  // !SSG_HAVE_JPEG

int ssg_jpeg_dims(const uint8_t*, size_t, int, int*, int*) { return 1; }
int ssg_decode_jpeg(const uint8_t*, size_t, int, uint8_t*, int, int) {
  return 1;
}
int ssg_jpeg_class(const uint8_t*, size_t) { return -1; }
int ssg_jpeg_meta(const uint8_t*, size_t, int, int*, int*) { return -1; }
int ssg_has_jpeg() { return 0; }

#endif  // SSG_HAVE_JPEG

}  // extern "C"
