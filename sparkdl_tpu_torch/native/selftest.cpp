// Sanitizer self-test of the port's batch packer (batchpack.cpp).
//
// The port's counterpart of sparkdl_tpu/native/selftest.cpp (its Makefile's
// `asan` target): built with -fsanitize=address,undefined together with
// batchpack.cpp and run, it drives the ABI version, the float pack over
// rows of mixed modes and sizes (uint8 gray, uint8 BGR, float BGRA, a row
// at the output size), the uint8 pack with and without the flip, and the
// float batch resize at an extreme change of aspect, so that the resize
// weights' boundary windows are read under the sanitizers. Exits 0 and
// prints "native selftest OK" when every call succeeds and every value is
// in range; any sanitizer report fails it.
//
//   g++ -g -O1 -std=c++17 -pthread -fsanitize=address,undefined \
//       -fno-sanitize-recover=all batchpack.cpp selftest.cpp -o selftest

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" {
int64_t sdl_pack_resize_batch(const uint8_t** datas, const int32_t* heights,
                              const int32_t* widths, const int32_t* channels,
                              const int32_t* modes, int64_t n, int32_t out_h, int32_t out_w,
                              int32_t out_c, int32_t bgr_to_rgb, float* out,
                              int32_t n_threads);
int64_t sdl_pack_batch_u8(const uint8_t** datas, const int32_t* heights,
                          const int32_t* widths, const int32_t* channels,
                          const int32_t* modes, int64_t n, int32_t out_h, int32_t out_w,
                          int32_t out_c, int32_t bgr_to_rgb, uint8_t* out,
                          int32_t n_threads);
int64_t sdl_resize_batch_f32(const float* src, int64_t n, int32_t h, int32_t w, int32_t c,
                             int32_t out_h, int32_t out_w, float* out, int32_t n_threads);
int32_t sdl_abi_version();
}

namespace {

struct Rows {
  std::vector<std::vector<uint8_t>> storage;
  std::vector<const uint8_t*> datas;
  std::vector<int32_t> hs, ws, cs, ms;
};

struct RowSpec {
  int32_t h, w, c, mode;
  bool f32;
};

Rows make_rows(const std::vector<RowSpec>& specs, unsigned seed) {
  Rows rows;
  rows.storage.reserve(specs.size());
  for (const RowSpec& s : specs) {
    const int64_t elems = static_cast<int64_t>(s.h) * s.w * s.c;
    std::vector<uint8_t> buf(static_cast<size_t>(elems * (s.f32 ? 4 : 1)));
    if (s.f32) {
      std::vector<float> f(static_cast<size_t>(elems));
      for (float& v : f) {
        seed = seed * 1664525u + 1013904223u;
        v = static_cast<float>(seed % 255);
      }
      std::copy(reinterpret_cast<const uint8_t*>(f.data()),
                reinterpret_cast<const uint8_t*>(f.data()) + buf.size(), buf.begin());
    } else {
      for (uint8_t& b : buf) {
        seed = seed * 1664525u + 1013904223u;
        b = static_cast<uint8_t>(seed % 255);
      }
    }
    rows.storage.push_back(std::move(buf));
    rows.datas.push_back(rows.storage.back().data());
    rows.hs.push_back(s.h);
    rows.ws.push_back(s.w);
    rows.cs.push_back(s.c);
    rows.ms.push_back(s.mode);
  }
  return rows;
}

bool in_range(const std::vector<float>& v) {
  for (float x : v)
    if (!(x >= 0.0f && x <= 255.0f)) return false;
  return true;
}

}  // namespace

int main() {
  if (sdl_abi_version() != 1) {
    std::fprintf(stderr, "ABI version %d, not 1\n", sdl_abi_version());
    return 1;
  }

  // mixed modes and sizes: CV_8UC1, CV_8UC3, CV_32FC4, and a CV_32FC3 row
  // already at the output size (no resize)
  const int32_t OH = 224, OW = 224;
  Rows mixed = make_rows({{17, 23, 1, 0, false},
                          {64, 48, 3, 16, false},
                          {9, 301, 4, 29, true},
                          {224, 224, 3, 21, true}},
                         7);
  const int64_t n = static_cast<int64_t>(mixed.datas.size());
  for (int32_t flip = 0; flip < 2; ++flip) {
    std::vector<float> out(static_cast<size_t>(n * OH * OW * 3), -1.0f);
    int64_t rc = sdl_pack_resize_batch(mixed.datas.data(), mixed.hs.data(), mixed.ws.data(),
                                       mixed.cs.data(), mixed.ms.data(), n, OH, OW, 3, flip,
                                       out.data(), 3);
    if (rc != 0 || !in_range(out)) {
      std::fprintf(stderr, "float pack (flip %d) failed at row %lld\n", flip,
                   static_cast<long long>(rc));
      return 2;
    }
  }

  // the uint8 pack at source size: three channels (flipped and not) from
  // BGR rows, one channel from gray rows; a float row is refused
  Rows bgr = make_rows({{31, 29, 3, 16, false}, {31, 29, 3, 16, false}}, 11);
  Rows gray = make_rows({{31, 29, 1, 0, false}}, 13);
  std::vector<uint8_t> u8(2 * 31 * 29 * 3);
  for (int32_t flip = 0; flip < 2; ++flip) {
    if (sdl_pack_batch_u8(bgr.datas.data(), bgr.hs.data(), bgr.ws.data(), bgr.cs.data(),
                          bgr.ms.data(), 2, 31, 29, 3, flip, u8.data(), 2) != 0) {
      std::fprintf(stderr, "uint8 pack (flip %d) failed\n", flip);
      return 3;
    }
  }
  std::vector<uint8_t> u8_gray(31 * 29);
  if (sdl_pack_batch_u8(gray.datas.data(), gray.hs.data(), gray.ws.data(), gray.cs.data(),
                        gray.ms.data(), 1, 31, 29, 1, 0, u8_gray.data(), 1) != 0) {
    std::fprintf(stderr, "one-channel uint8 pack failed\n");
    return 3;
  }
  Rows f32 = make_rows({{31, 29, 3, 21, true}}, 17);
  if (sdl_pack_batch_u8(f32.datas.data(), f32.hs.data(), f32.ws.data(), f32.cs.data(),
                        f32.ms.data(), 1, 31, 29, 3, 0, u8.data(), 1) == 0) {
    std::fprintf(stderr, "the uint8 pack took a float row\n");
    return 3;
  }

  // the float batch resize at extreme changes of aspect, both ways: the
  // boundary windows of the resize weights
  std::vector<float> src(2 * 7 * 150 * 3);
  for (size_t i = 0; i < src.size(); ++i) src[i] = static_cast<float>(i % 100);
  std::vector<float> tall(2 * 128 * 16 * 3, -1.0f);
  std::vector<float> one(2 * 1 * 301 * 3, -1.0f);
  if (sdl_resize_batch_f32(src.data(), 2, 7, 150, 3, 128, 16, tall.data(), 2) != 0 ||
      sdl_resize_batch_f32(src.data(), 2, 7, 150, 3, 1, 301, one.data(), 0) != 0 ||
      !in_range(tall) || !in_range(one)) {
    std::fprintf(stderr, "float resize failed\n");
    return 4;
  }

  std::puts("native selftest OK");
  return 0;
}
