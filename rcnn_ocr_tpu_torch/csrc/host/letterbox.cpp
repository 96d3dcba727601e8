// Parallel uint8 batch letterbox for the serving input pipeline.
//
// The port's serving path (`OCRInference.predict_serving`) ships raw uint8
// pixels letterboxed into a fixed canvas; resize, pad and normalize run on
// the device.  A per-image numpy paste holds the interpreter lock and runs on
// one core; this is a thread-pooled memcpy, called through ctypes (which
// releases the lock for the call).  The port's own copy of the JAX package's
// `native/letterbox.cpp`.
//
// Contract: srcs[i] points to a contiguous HWC uint8 image of src_h[i] x
// src_w[i] x 3; out is [n, ch, cw, 3] (need not be pre-zeroed: padding is
// cleared here).  Images larger than the canvas are cropped.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" int64_t rcnn_letterbox_u8(
    const uint8_t* const* srcs,
    const int64_t* src_h,
    const int64_t* src_w,
    int64_t n,
    uint8_t* out,
    int64_t ch,
    int64_t cw,
    int64_t n_threads) {
  if (srcs == nullptr || src_h == nullptr || src_w == nullptr ||
      out == nullptr || n < 0 || ch <= 0 || cw <= 0) {
    return -1;
  }
  const int64_t row_bytes = cw * 3;
  const int64_t img_bytes = ch * row_bytes;

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* src = srcs[i];
      // clamp below at 0 too: a negative height would memset before the
      // output buffer and a negative width turns the row memset size into a
      // huge size_t
      const int64_t h = std::max<int64_t>(0, std::min<int64_t>(src_h[i], ch));
      const int64_t w = std::max<int64_t>(0, std::min<int64_t>(src_w[i], cw));
      const int64_t src_row = src_w[i] * 3;
      uint8_t* dst = out + i * img_bytes;
      for (int64_t r = 0; r < h; ++r) {
        std::memcpy(dst + r * row_bytes, src + r * src_row,
                    static_cast<size_t>(w) * 3);
        std::memset(dst + r * row_bytes + w * 3, 0,
                    static_cast<size_t>(cw - w) * 3);
      }
      if (h < ch) {
        std::memset(dst + h * row_bytes, 0,
                    static_cast<size_t>(ch - h) * row_bytes);
      }
    }
  };

  int64_t t = n_threads > 0
                  ? n_threads
                  : static_cast<int64_t>(std::thread::hardware_concurrency());
  t = std::max<int64_t>(1, std::min<int64_t>(t, n > 0 ? n : 1));
  if (t == 1 || n < 64) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  try {  // thread-resource exhaustion must fail the call, not the process
    pool.reserve(static_cast<size_t>(t));
    const int64_t chunk = (n + t - 1) / t;
    for (int64_t k = 0; k < t; ++k) {
      const int64_t lo = k * chunk;
      const int64_t hi = std::min<int64_t>(n, lo + chunk);
      if (lo >= hi) break;
      pool.emplace_back(work, lo, hi);
    }
  } catch (...) {
    for (auto& th : pool) th.join();
    work(0, n);  // serial fallback still completes the job
    return 0;
  }
  for (auto& th : pool) th.join();
  return 0;
}
