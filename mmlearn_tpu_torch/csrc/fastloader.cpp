// fastloader: multithreaded JPEG decode + resize + crop on the host, and the
// CRC-32C of TFRecord framing. A copy of mmlearn_tpu/native/fastloader.cpp
// with the same C ABI (fl_decode_jpeg_resize, fl_decode_jpeg_train,
// fl_decode_jpeg_batch_train, fl_decode_jpeg_batch, fl_crc32c) and the same
// arithmetic, so that both builds give the same bytes. It is host C++, not a
// card kernel: it replaces no TPU kernel, and the card never runs it.
//
// A C++ thread pool decodes JPEG bytes with libjpeg, bilinear-resamples a
// crop rect (eval: the shorter side to `out_size`, centred; train: a
// random-resized crop and a horizontal flip drawn from a per-image seed) and
// writes dense (N, out_size, out_size, 3) uint8 -- one call a batch, no
// Python in the loop. Failed decodes are zeroed and counted.
//
// Decode cost scales with decoded pixels, so both paths use libjpeg's
// DCT-domain scaling (scale_num/8): the crop geometry is computed against the
// full-resolution dimensions (header probe), then the image is decoded at the
// smallest power-of-two m/8 that still leaves the crop at >= out_size pixels
// per axis, and the crop rect is mapped into the scaled frame. The crop
// distribution is unchanged. MMLEARN_FASTLOADER_NO_DCT_SCALE=1, read on each
// call, turns it off.
//
// Built by mmlearn_tpu_torch/_build.py (build_host) at first use, with the
// JAX package's flags in its order: g++ -march=native -O3 -shared -fPIC
// fastloader.cpp -ljpeg -lpthread, then the same without -march=native.
// With -DFASTLOADER_CRC_ONLY only fl_crc32c is compiled, without libjpeg: the
// TFRecord reader's checksum library, for hosts that lack libjpeg.
#include <cstddef>
#include <cstdio>
#include <cstdlib>

#ifndef FASTLOADER_CRC_ONLY
#include <jpeglib.h>
#endif

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>  // hardware CRC32C (_mm_crc32_u64/_u8)
#endif

#ifndef FASTLOADER_CRC_ONLY
namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Read per call (not cached) so tests can toggle via os.environ; getenv is
// nanoseconds against a multi-ms decode.
bool dct_scaling_enabled() {
  const char* v = std::getenv("MMLEARN_FASTLOADER_NO_DCT_SCALE");
  return v == nullptr || v[0] == '\0' || v[0] == '0';
}

// Header-only probe for the full-resolution dimensions (microseconds; the
// train path needs them to draw the crop rect before picking a decode scale).
bool peek_jpeg_dims(const uint8_t* data, size_t len, int& width, int& height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
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
  width = static_cast<int>(cinfo.image_width);
  height = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Decode JPEG bytes into an RGB buffer. `min_dim > 0` requests DCT-domain
// scaling: the smallest m/8 (m in 1..8) whose scaled output keeps BOTH axes'
// crop extents >= the target resolution, i.e. min(crop_w, crop_h) scaled by
// m/8 stays >= min_dim. Callers pass min_dim relative to the *full-res crop
// extent* they plan to resample from; we translate that to a bound on the
// whole image via crop_short (the crop's shorter full-res extent).
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>& out,
                 int& width, int& height, double& scale_x, double& scale_y,
                 int crop_short = 0, int min_dim = 0) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
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
  cinfo.out_color_space = JCS_RGB;
  scale_x = scale_y = 1.0;
  if (dct_scaling_enabled() && crop_short > 0 && min_dim > 0 &&
      crop_short > min_dim) {
    // Only power-of-two ratios (1/2, 1/4, 1/8): libjpeg-turbo's scaled IDCT
    // is SIMD-optimized for those, while the odd m/8 kernels are scalar C
    // and measure SLOWER than a full SIMD 8x8 decode (A/B'd: 500x375 at 5/8
    // lost 30%; 1024x768 at 1/2 won 1.9x). Pick the smallest m in {1, 2, 4}
    // with crop_short * m / 8 >= min_dim.
    for (int m = 1; m <= 4; m *= 2) {
      if (static_cast<int64_t>(crop_short) * m / 8 >= min_dim) {
        cinfo.scale_num = static_cast<unsigned>(m);
        cinfo.scale_denom = 8;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  width = static_cast<int>(cinfo.output_width);
  height = static_cast<int>(cinfo.output_height);
  // libjpeg ceil-rounds each scaled axis INDEPENDENTLY (output = ceil(dim *
  // m / 8)), so the effective scale differs per axis; mapping both axes
  // with the width ratio would shift the vertical crop near the bottom edge
  scale_x = static_cast<double>(cinfo.output_width) / cinfo.image_width;
  scale_y = static_cast<double>(cinfo.output_height) / cinfo.image_height;
  out.resize(static_cast<size_t>(width) * height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) *
                                    width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resample of a source crop rect (cx, cy, cw, ch) to a square
// (out_size, out_size) output; optional horizontal flip. The x-axis sample
// positions are identical for every output row, so their taps (x0, x1, fx)
// are precomputed once; all blending runs in float.
void resample_crop(const uint8_t* src, int w, int h, double cx, double cy,
                   double cw, double ch, int out_size, bool hflip,
                   uint8_t* dst) {
  const double sx_scale = cw / out_size;
  const double sy_scale = ch / out_size;
  std::vector<int> x0s(out_size), x1s(out_size);
  std::vector<float> fxs(out_size);
  for (int ox = 0; ox < out_size; ++ox) {
    const double sx = cx + (ox + 0.5) * sx_scale - 0.5;
    const int x0 = sx <= 0 ? 0 : static_cast<int>(sx);
    x0s[ox] = x0 < w - 1 ? x0 : w - 1;
    x1s[ox] = x0 + 1 < w ? x0 + 1 : w - 1;
    fxs[ox] = static_cast<float>(sx - x0 < 0 ? 0 : sx - x0);
  }
  for (int oy = 0; oy < out_size; ++oy) {
    const double sy = cy + (oy + 0.5) * sy_scale - 0.5;
    int y0 = sy <= 0 ? 0 : static_cast<int>(sy);
    if (y0 > h - 1) y0 = h - 1;
    const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const float fy = static_cast<float>(sy - y0 < 0 ? 0 : sy - y0);
    const uint8_t* row0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * w * 3;
    uint8_t* drow = dst + static_cast<size_t>(oy) * out_size * 3;
    for (int ox = 0; ox < out_size; ++ox) {
      const int out_x = hflip ? out_size - 1 - ox : ox;
      const uint8_t* p00 = row0 + x0s[ox] * 3;
      const uint8_t* p01 = row0 + x1s[ox] * 3;
      const uint8_t* p10 = row1 + x0s[ox] * 3;
      const uint8_t* p11 = row1 + x1s[ox] * 3;
      const float fx = fxs[ox];
      const float w00 = (1.0f - fy) * (1.0f - fx);
      const float w01 = (1.0f - fy) * fx;
      const float w10 = fy * (1.0f - fx);
      const float w11 = fy * fx;
      uint8_t* d = drow + out_x * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = p00[c] * w00 + p01[c] * w01 + p10[c] * w10 +
                        p11[c] * w11;
        d[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Eval path: shorter side -> out_size, center crop. Matches
// mmlearn_tpu_torch.datasets.builtin.image_utils.ImageTransform(train=False).
// The crop rect is derived in FULL-RES coordinates (identical to the
// unscaled implementation), then mapped by the decode scale actually applied.
void resize_center_crop(const uint8_t* src, int w, int h, double scale_x,
                        double scale_y, int full_w, int full_h, int out_size,
                        uint8_t* dst) {
  const int short_side = full_w < full_h ? full_w : full_h;
  const double scale = static_cast<double>(out_size) / short_side;
  const int nw = static_cast<int>(std::lround(full_w * scale));
  const int nh = static_cast<int>(std::lround(full_h * scale));
  const int left = (nw - out_size) / 2;
  const int top = (nh - out_size) / 2;
  // crop rect in full-res source coordinates, mapped per-axis to decoded
  // coordinates
  resample_crop(src, w, h, (left / scale) * scale_x,
                (top / scale) * scale_y,
                (out_size / scale) * scale_x,
                (out_size / scale) * scale_y, out_size,
                /*hflip=*/false, dst);
}

// splitmix64: tiny deterministic per-image RNG for the train augmentations.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    state += 0x9e3779b97f4a7c15ULL;
    uint64_t z = state;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

// Train-path crop parameters drawn against the FULL-RES dimensions, so the
// augmentation distribution is independent of the decode scale chosen.
// Matches ImageTransform(train=True): scale ~ U(smin, smax),
// crop = (w*sqrt(s), h*sqrt(s)) at a uniform offset, flip with p=pflip.
struct TrainCrop {
  int left, top, cw, ch;
  bool flip;
};

TrainCrop draw_train_crop(int w, int h, double smin, double smax, double pflip,
                          uint64_t seed) {
  Rng rng(seed);
  const double s = smin + (smax - smin) * rng.uniform();
  const double root = std::sqrt(s);
  TrainCrop crop;
  crop.cw = w * root < 1 ? 1 : static_cast<int>(w * root);
  crop.ch = h * root < 1 ? 1 : static_cast<int>(h * root);
  const int max_left = w - crop.cw > 0 ? w - crop.cw : 0;
  const int max_top = h - crop.ch > 0 ? h - crop.ch : 0;
  crop.left = max_left > 0 ? static_cast<int>(rng.next() % (max_left + 1)) : 0;
  crop.top = max_top > 0 ? static_cast<int>(rng.next() % (max_top + 1)) : 0;
  crop.flip = rng.uniform() < pflip;
  return crop;
}

}  // namespace
#endif  // FASTLOADER_CRC_ONLY

extern "C" {

#ifndef FASTLOADER_CRC_ONLY

// Decode one JPEG and write (out_size, out_size, 3) uint8. Returns 0 on
// success, nonzero on decode failure.
int fl_decode_jpeg_resize(const uint8_t* data, size_t len, int out_size,
                          uint8_t* out) {
  int full_w = 0, full_h = 0;
  if (!peek_jpeg_dims(data, len, full_w, full_h)) return 1;
  std::vector<uint8_t> raw;
  int w = 0, h = 0;
  double scale_x = 1.0, scale_y = 1.0;
  // the center crop spans the full short side; keep it >= out_size decoded
  const int crop_short = full_w < full_h ? full_w : full_h;
  if (!decode_jpeg(data, len, raw, w, h, scale_x, scale_y, crop_short,
                   out_size)) {
    return 1;
  }
  resize_center_crop(raw.data(), w, h, scale_x, scale_y, full_w, full_h,
                     out_size, out);
  return 0;
}

// Train-path decode: random-resized-crop (area scale in [smin, smax]) +
// random horizontal flip (p=pflip), seeded per call. Returns 0 on success.
int fl_decode_jpeg_train(const uint8_t* data, size_t len, int out_size,
                         double smin, double smax, double pflip, uint64_t seed,
                         uint8_t* out) {
  int full_w = 0, full_h = 0;
  if (!peek_jpeg_dims(data, len, full_w, full_h)) return 1;
  const TrainCrop crop =
      draw_train_crop(full_w, full_h, smin, smax, pflip, seed);
  std::vector<uint8_t> raw;
  int w = 0, h = 0;
  double scale_x = 1.0, scale_y = 1.0;
  const int crop_short = crop.cw < crop.ch ? crop.cw : crop.ch;
  if (!decode_jpeg(data, len, raw, w, h, scale_x, scale_y, crop_short,
                   out_size)) {
    return 1;
  }
  resample_crop(raw.data(), w, h, crop.left * scale_x, crop.top * scale_y,
                crop.cw * scale_x, crop.ch * scale_y, out_size, crop.flip,
                out);
  return 0;
}

// Batched train-path decode with per-image seeds and a thread pool.
int fl_decode_jpeg_batch_train(const uint8_t* blob, const size_t* offsets,
                               int n, int out_size, double smin, double smax,
                               double pflip, const uint64_t* seeds,
                               uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  const size_t item = static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* data = blob + offsets[i];
      const size_t len = offsets[i + 1] - offsets[i];
      if (fl_decode_jpeg_train(data, len, out_size, smin, smax, pflip,
                               seeds[i], out + item * i) != 0) {
        std::memset(out + item * i, 0, item);
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Batch variant with an internal thread pool. `offsets` has n+1 entries into
// `blob`; output is (n, out_size, out_size, 3) contiguous. Returns the number
// of failed decodes (their slots are zeroed).
int fl_decode_jpeg_batch(const uint8_t* blob, const size_t* offsets, int n,
                         int out_size, uint8_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  const size_t item = static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* data = blob + offsets[i];
      const size_t len = offsets[i + 1] - offsets[i];
      if (fl_decode_jpeg_resize(data, len, out_size, out + item * i) != 0) {
        std::memset(out + item * i, 0, item);
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

#endif  // FASTLOADER_CRC_ONLY

// ---- CRC32C (Castagnoli) ----------------------------------------------------
// TFRecord framing checksums (mmlearn_tpu_torch/datasets/core/tfrecord.py):
// the pure-Python byte loop runs at a few MB/s. x86 builds (-march=native)
// use the SSE4.2 CRC32 instruction; the portable fallback is slice-by-8.
// Both assume little-endian 8-byte loads (x86/ARM).

#if !defined(__SSE4_2__)
namespace {
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      t[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = t[0][n];
      for (int k = 1; k < 8; ++k) {
        c = t[0][c & 0xFF] ^ (c >> 8);
        t[k][n] = c;
      }
    }
  }
};
const Crc32cTables& crc_tables() {
  static const Crc32cTables tbl;  // thread-safe magic static
  return tbl;
}
}  // namespace
#endif

uint32_t fl_crc32c(const uint8_t* data, size_t n, uint32_t crc) {
  crc ^= 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, data, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, v));
    data += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *data++);
#else
  const auto& t = crc_tables().t;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, data, 8);
    v ^= crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^
          t[0][(v >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
#endif
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
