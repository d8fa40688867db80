// Native PNG scanline filter/unfilter loops (the byte-sequential part of
// the codec NumPy cannot vectorize).  Counterpart of the reference's
// vendored stb codec role (reference stb.cpp / stb_image/ — reimplemented
// from the PNG spec, RFC 2083 §6, not ported).
//
// Built as a plain shared library (no Python headers) and loaded via
// ctypes; see build.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// raw: h x (stride+1) filtered scanlines (leading filter-type byte each);
// out: h x stride reconstructed bytes.  Returns 0, or 1+y on a bad filter
// type at scanline y.
int png_unfilter(const uint8_t* raw, uint8_t* out, int h, int stride,
                 int bpp) {
  const uint8_t* zero = static_cast<uint8_t*>(std::calloc(stride, 1));
  const uint8_t* prev = zero;
  int rc = 0;
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
    uint8_t ft = line[0];
    const uint8_t* src = line + 1;
    uint8_t* dst = out + static_cast<size_t>(y) * stride;
    switch (ft) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (int x = 0; x < bpp; ++x) dst[x] = src[x];
        for (int x = bpp; x < stride; ++x) dst[x] = src[x] + dst[x - bpp];
        break;
      case 2:  // Up
        for (int x = 0; x < stride; ++x) dst[x] = src[x] + prev[x];
        break;
      case 3:  // Average
        for (int x = 0; x < bpp; ++x) dst[x] = src[x] + (prev[x] >> 1);
        for (int x = bpp; x < stride; ++x)
          dst[x] = src[x] + ((dst[x - bpp] + prev[x]) >> 1);
        break;
      case 4:  // Paeth
        for (int x = 0; x < bpp; ++x) dst[x] = src[x] + paeth(0, prev[x], 0);
        for (int x = bpp; x < stride; ++x)
          dst[x] = src[x] + paeth(dst[x - bpp], prev[x], prev[x - bpp]);
        break;
      default:
        rc = 1 + y;
    }
    if (rc) break;
    prev = dst;
  }
  std::free(const_cast<uint8_t*>(zero));
  return rc;
}

// src: h x stride raw scanlines; out: h x (stride+1) filtered scanlines.
// Per scanline picks the filter minimizing sum of |signed byte| (the
// standard heuristic).  try_all=0 restricts to {None, Sub, Up} (faster).
void png_filter(const uint8_t* src, uint8_t* out, int h, int stride, int bpp,
                int try_all) {
  uint8_t* zero = static_cast<uint8_t*>(std::calloc(stride, 1));
  const uint8_t* prev = zero;
  uint8_t* cand = static_cast<uint8_t*>(std::malloc(stride));
  uint8_t* best = static_cast<uint8_t*>(std::malloc(stride));
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = src + static_cast<size_t>(y) * stride;
    uint8_t* dst = out + static_cast<size_t>(y) * (stride + 1);
    long best_score = -1;
    int best_ft = 0;
    int n_filters = try_all ? 5 : 3;
    for (int ft = 0; ft < n_filters; ++ft) {
      long score = 0;
      for (int x = 0; x < stride; ++x) {
        int a = x >= bpp ? line[x - bpp] : 0;
        int b = prev[x];
        int c = x >= bpp ? prev[x - bpp] : 0;
        uint8_t v;
        switch (ft) {
          case 0: v = line[x]; break;
          case 1: v = line[x] - a; break;
          case 2: v = line[x] - b; break;
          case 3: v = line[x] - ((a + b) >> 1); break;
          default: v = line[x] - paeth(a, b, c); break;
        }
        cand[x] = v;
        score += v < 128 ? v : 256 - v;
        if (best_score >= 0 && score >= best_score) {
          // early out: this candidate already lost
          if (x < stride - 1) score = -2;
          break;
        }
      }
      if (score == -2) continue;
      if (best_score < 0 || score < best_score) {
        best_score = score;
        best_ft = ft;
        std::memcpy(best, cand, stride);
      }
    }
    dst[0] = static_cast<uint8_t>(best_ft);
    std::memcpy(dst + 1, best, stride);
    prev = line;
  }
  std::free(zero);
  std::free(cand);
  std::free(best);
}

}  // extern "C"
