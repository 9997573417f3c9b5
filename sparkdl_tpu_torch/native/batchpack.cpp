// sparkdl_tpu_torch native batch packer: the host half of the decode in
// front of the port's batched forwards (transformers/utils.py).
//
// Spark-ImageSchema structs (raw bytes + h/w/c/mode) are decoded,
// channel-normalized (gray replicated, alpha dropped, ITU-R 601 luminance
// for one channel), optionally BGR->RGB flipped, and packed into one
// contiguous NHWC batch, threaded across rows: one C call per chunk instead
// of a per-row Python loop. The batch then goes to the card through pinned
// staging (engine/executor.py::PinnedStaging).
//
// Three entry points:
//   sdl_pack_batch_u8      uint8 rows at source size -> uint8 NHWC (the
//                          forward casts on the card: a quarter of the bytes)
//   sdl_pack_resize_batch  any rows -> float32 NHWC, resized where a row is
//                          not at (out_h, out_w)
//   sdl_resize_batch_f32   a same-shaped float32 NHWC batch -> resized
//
// The resize reproduces jax.image.resize(method="linear", antialias=True):
// half-pixel centres, a triangle kernel widened by the downscale factor,
// weights renormalized per output cell; the port's device resize
// (transformers/utils.py::resize_bilinear) computes the same weights. At
// source size the float pack is bit-equal to the numpy pack.
//
// Host C++ only (no CUDA). C ABI, loaded through ctypes (native/__init__.py),
// which also picks each call's thread count by its output's size.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// OpenCV type ordinals used by the image schema (imageIO._OCV_TYPES).
enum OcvMode : int32_t {
  CV_8UC1 = 0,
  CV_8UC3 = 16,
  CV_8UC4 = 24,
  CV_32FC1 = 5,
  CV_32FC3 = 21,
  CV_32FC4 = 29,
};

bool mode_is_float(int32_t mode) {
  return mode == CV_32FC1 || mode == CV_32FC3 || mode == CV_32FC4;
}

// Element `idx` of a row's data, stored as T, as float (memcpy: the bytes
// need not be aligned for T).
template <typename T>
inline float load_at(const uint8_t* data, int64_t idx) {
  T v;
  std::memcpy(&v, data + idx * static_cast<int64_t>(sizeof(T)), sizeof(T));
  return static_cast<float>(v);
}

// decode_row for data stored as T (uint8_t or float): one loop per case
// with the element type fixed, so the plain copy vectorizes.
template <typename T>
bool decode_row_as(const uint8_t* data, int64_t hw, int32_t c, int32_t out_c,
                   bool bgr_to_rgb, float* dst) {
  auto load = [&](int64_t px, int32_t ch) -> float {
    return load_at<T>(data, px * c + ch);
  };
  if (out_c == c && out_c != 1 && !bgr_to_rgb) {
    for (int64_t i = 0; i < hw * c; ++i) dst[i] = load_at<T>(data, i);
    return true;
  }
  if (out_c == c && out_c != 1) {
    for (int64_t px = 0; px < hw; ++px) {
      for (int32_t ch = 0; ch < out_c; ++ch) {
        int32_t src = (bgr_to_rgb && ch < 3) ? (2 - ch) : ch;
        dst[px * out_c + ch] = load(px, src);
      }
    }
    return true;
  }
  if (out_c == 3) {
    if (c == 1) {
      for (int64_t px = 0; px < hw; ++px) {
        float v = load(px, 0);
        dst[px * 3] = v;
        dst[px * 3 + 1] = v;
        dst[px * 3 + 2] = v;
      }
      return true;
    }
    if (c == 4) {  // drop alpha (stored BGRA)
      for (int64_t px = 0; px < hw; ++px) {
        for (int32_t ch = 0; ch < 3; ++ch) {
          int32_t src = bgr_to_rgb ? (2 - ch) : ch;
          dst[px * 3 + ch] = load(px, src);
        }
      }
      return true;
    }
    return false;
  }
  if (out_c == 1) {
    if (c == 1) {
      for (int64_t px = 0; px < hw; ++px) dst[px] = load(px, 0);
      return true;
    }
    if (c >= 3) {  // stored order BGR: 0.114 B + 0.587 G + 0.299 R
      for (int64_t px = 0; px < hw; ++px) {
        dst[px] = 0.114f * load(px, 0) + 0.587f * load(px, 1) +
                  0.299f * load(px, 2);
      }
      return true;
    }
  }
  return false;
}

// Decode one struct's raw bytes into float32 HWC with `out_c` channels
// (replicate gray; drop alpha; ITU-R 601 luminance on stored-BGR for 1ch),
// optionally flipping BGR->RGB.  Returns false on unsupported conversion.
bool decode_row(const uint8_t* data, int32_t h, int32_t w, int32_t c,
                int32_t mode, int32_t out_c, bool bgr_to_rgb, float* dst) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  return mode_is_float(mode)
             ? decode_row_as<float>(data, hw, c, out_c, bgr_to_rgb, dst)
             : decode_row_as<uint8_t>(data, hw, c, out_c, bgr_to_rgb, dst);
}

struct ResizeWeights {
  // For each output index: [start, end) input window + normalized weights.
  std::vector<int32_t> start;
  std::vector<int32_t> len;
  std::vector<float> weights;  // ragged, indexed via offsets
  std::vector<int64_t> offset;
};

// jax.image.resize(method="linear", antialias=True) weight schedule.
ResizeWeights linear_weights(int32_t in_size, int32_t out_size) {
  ResizeWeights rw;
  rw.start.resize(out_size);
  rw.len.resize(out_size);
  rw.offset.resize(out_size);
  const double scale = static_cast<double>(out_size) / in_size;
  const double kernel_scale = std::max(1.0 / scale, 1.0);  // antialias widen
  int64_t total = 0;
  for (int32_t o = 0; o < out_size; ++o) {
    const double center = (o + 0.5) / scale - 0.5;
    int32_t lo = static_cast<int32_t>(
        std::ceil(center - kernel_scale - 1e-9));
    int32_t hi = static_cast<int32_t>(
        std::floor(center + kernel_scale + 1e-9));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size - 1);
    double sum = 0.0;
    std::vector<double> w(hi - lo + 1);
    for (int32_t i = lo; i <= hi; ++i) {
      double x = std::abs(i - center) / kernel_scale;
      double v = std::max(0.0, 1.0 - x);
      w[i - lo] = v;
      sum += v;
    }
    rw.start[o] = lo;
    rw.len[o] = hi - lo + 1;
    rw.offset[o] = total;
    for (double v : w) {
      rw.weights.push_back(sum > 0 ? static_cast<float>(v / sum) : 0.0f);
    }
    total += hi - lo + 1;
  }
  return rw;
}

// Separable resize HWC float32 -> (out_h, out_w, c).
void resize_bilinear(const float* src, int32_t /*h*/, int32_t w, int32_t c,
                     const ResizeWeights& wh, const ResizeWeights& ww,
                     int32_t out_h, int32_t out_w, float* dst,
                     float* tmp /* out_h * w * c scratch */) {
  // rows first: (h, w, c) -> (out_h, w, c)
  for (int32_t oy = 0; oy < out_h; ++oy) {
    const int32_t ys = wh.start[oy], yl = wh.len[oy];
    const float* wv = wh.weights.data() + wh.offset[oy];
    float* trow = tmp + static_cast<int64_t>(oy) * w * c;
    std::fill(trow, trow + static_cast<int64_t>(w) * c, 0.0f);
    for (int32_t k = 0; k < yl; ++k) {
      const float wk = wv[k];
      const float* srow = src + static_cast<int64_t>(ys + k) * w * c;
      for (int64_t i = 0; i < static_cast<int64_t>(w) * c; ++i) {
        trow[i] += wk * srow[i];
      }
    }
  }
  // then columns: (out_h, w, c) -> (out_h, out_w, c)
  for (int32_t oy = 0; oy < out_h; ++oy) {
    const float* trow = tmp + static_cast<int64_t>(oy) * w * c;
    float* drow = dst + static_cast<int64_t>(oy) * out_w * c;
    for (int32_t ox = 0; ox < out_w; ++ox) {
      const int32_t xs = ww.start[ox], xl = ww.len[ox];
      const float* wv = ww.weights.data() + ww.offset[ox];
      for (int32_t ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int32_t k = 0; k < xl; ++k) {
          acc += wv[k] * trow[static_cast<int64_t>(xs + k) * c + ch];
        }
        drow[static_cast<int64_t>(ox) * c + ch] = acc;
      }
    }
  }
}

// Run `worker` on n_threads threads, the calling thread one of them: a
// call of one thread starts none (a start costs tens of microseconds, more
// than packing a small chunk).
template <typename Worker>
void run_workers(int32_t n_threads, Worker& worker) {
  std::vector<std::thread> threads;
  threads.reserve(n_threads > 1 ? n_threads - 1 : 0);
  for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(std::ref(worker));
  worker();
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Decode + normalize + (optionally) resize + pack N image structs into a
// contiguous float32 NHWC batch.  Rows may have heterogeneous shapes; each
// is resized to (out_h, out_w).  When a row already matches (out_h, out_w)
// the resize is skipped (pure pack), keeping parity with the Python path.
// Returns 0 on success, or 1-based index of the first row that failed.
int64_t sdl_pack_resize_batch(const uint8_t** datas, const int32_t* heights,
                              const int32_t* widths, const int32_t* channels,
                              const int32_t* modes, int64_t n, int32_t out_h,
                              int32_t out_w, int32_t out_c,
                              int32_t bgr_to_rgb, float* out,
                              int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min<int64_t>(n_threads, n);

  std::atomic<int64_t> failed{0};
  std::atomic<int64_t> next{0};
  const int64_t out_stride = static_cast<int64_t>(out_h) * out_w * out_c;

  auto worker = [&]() {
    std::vector<float> decoded, scratch;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) return;
      const int32_t h = heights[i], w = widths[i], c = channels[i];
      if (h <= 0 || w <= 0 || c <= 0) {
        failed.store(i + 1);
        return;
      }
      float* dst = out + i * out_stride;
      if (h == out_h && w == out_w) {
        if (!decode_row(datas[i], h, w, c, modes[i], out_c,
                        bgr_to_rgb != 0, dst)) {
          failed.store(i + 1);
          return;
        }
        continue;
      }
      decoded.resize(static_cast<int64_t>(h) * w * out_c);
      if (!decode_row(datas[i], h, w, c, modes[i], out_c, bgr_to_rgb != 0,
                      decoded.data())) {
        failed.store(i + 1);
        return;
      }
      const ResizeWeights wh = linear_weights(h, out_h);
      const ResizeWeights ww = linear_weights(w, out_w);
      scratch.resize(static_cast<int64_t>(out_h) * w * out_c);
      resize_bilinear(decoded.data(), h, w, out_c, wh, ww, out_h, out_w, dst,
                      scratch.data());
    }
  };

  run_workers(n_threads, worker);
  return failed.load();
}

// Pack N *uint8* image structs into a contiguous uint8 NHWC batch, no
// resize (all rows must already be (out_h, out_w)).  Channel handling:
// replicate gray -> 3, drop alpha, optional BGR->RGB flip.  uint8 ingest
// quarters the bytes shipped host->device — the link is the bottleneck of
// the serving path, so the cast to float happens on-device instead.
// Returns 0 on success, or 1-based index of the first unsupported row.
int64_t sdl_pack_batch_u8(const uint8_t** datas, const int32_t* heights,
                          const int32_t* widths, const int32_t* channels,
                          const int32_t* modes, int64_t n, int32_t out_h,
                          int32_t out_w, int32_t out_c, int32_t bgr_to_rgb,
                          uint8_t* out, int32_t n_threads) {
  if (n <= 0) return 0;
  if (out_c != 3 && out_c != 1) return 1;
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min<int64_t>(n_threads, n);
  std::atomic<int64_t> failed{0};
  std::atomic<int64_t> next{0};
  const int64_t out_stride = static_cast<int64_t>(out_h) * out_w * out_c;

  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) return;
      const int32_t h = heights[i], w = widths[i], c = channels[i];
      const int32_t mode = modes[i];
      if (h != out_h || w != out_w || mode_is_float(mode) ||
          (out_c == 1 && c != 1)) {
        failed.store(i + 1);
        return;
      }
      const uint8_t* src = datas[i];
      uint8_t* dst = out + i * out_stride;
      const int64_t hw = static_cast<int64_t>(h) * w;
      if (c == out_c && !(bgr_to_rgb && c >= 3)) {
        std::memcpy(dst, src, hw * c);
      } else if (out_c == 3 && c == 1) {
        for (int64_t px = 0; px < hw; ++px) {
          const uint8_t v = src[px];
          dst[px * 3] = v;
          dst[px * 3 + 1] = v;
          dst[px * 3 + 2] = v;
        }
      } else if (out_c == 3 && (c == 3 || c == 4)) {
        for (int64_t px = 0; px < hw; ++px) {
          for (int32_t ch = 0; ch < 3; ++ch) {
            const int32_t s = (bgr_to_rgb ? (2 - ch) : ch);
            dst[px * 3 + ch] = src[px * c + s];
          }
        }
      } else {
        failed.store(i + 1);
        return;
      }
    }
  };
  run_workers(n_threads, worker);
  return failed.load();
}

// Resize a batch of same-shaped float32 HWC images (no decode step) —
// the native replacement for the host-resize fallback.
int64_t sdl_resize_batch_f32(const float* src, int64_t n, int32_t h,
                             int32_t w, int32_t c, int32_t out_h,
                             int32_t out_w, float* out, int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min<int64_t>(n_threads, n);
  const ResizeWeights wh = linear_weights(h, out_h);
  const ResizeWeights ww = linear_weights(w, out_w);
  const int64_t in_stride = static_cast<int64_t>(h) * w * c;
  const int64_t out_stride = static_cast<int64_t>(out_h) * out_w * c;
  std::atomic<int64_t> next{0};

  auto worker = [&]() {
    std::vector<float> scratch(static_cast<int64_t>(out_h) * w * c);
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      resize_bilinear(src + i * in_stride, h, w, c, wh, ww, out_h, out_w,
                      out + i * out_stride, scratch.data());
    }
  };
  run_workers(n_threads, worker);
  return 0;
}

int32_t sdl_abi_version() { return 1; }

}  // extern "C"
