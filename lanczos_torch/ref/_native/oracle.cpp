// Native inner loop of the C-oracle height pass (full_TB.h:67-77):
// in-place, bottom-up, double accumulation over precomputed taps, with
// the double→uint8 saturate-then-truncate cast (full_TB.h:29-37).
//
// Weights/indices are computed host-side in NumPy (identical float64
// values); this routine only performs the sequential accumulation, so it
// is bit-identical to the Python loop it replaces.  Compiled with
// -ffp-contract=off so a*b+c never fuses into FMA (NumPy does not fuse).

#include <cstdint>

extern "C" {

// buf: (out_h, row_elems) uint8, updated in place from xx = out_h-1 down
// to 0; idx: (out_h, taps) int32 row indices; w: (out_h, taps) float64.
void oracle_height_pass(uint8_t* buf, int out_h, long row_elems,
                        const int32_t* idx, const double* w, int taps) {
  double* acc = new double[row_elems];
  for (int xx = out_h - 1; xx >= 0; --xx) {
    for (long e = 0; e < row_elems; ++e) acc[e] = 0.0;
    for (int j = 0; j < taps; ++j) {
      const double wj = w[static_cast<long>(xx) * taps + j];
      if (wj == 0.0) continue;
      const uint8_t* src =
          buf + static_cast<long>(idx[static_cast<long>(xx) * taps + j]) *
                    row_elems;
      for (long e = 0; e < row_elems; ++e)
        acc[e] += wj * static_cast<double>(src[e]);
    }
    uint8_t* dst = buf + static_cast<long>(xx) * row_elems;
    for (long e = 0; e < row_elems; ++e) {
      double v = acc[e];
      if (v < 0.0) v = 0.0;
      if (v > 255.0) v = 255.0;
      dst[e] = static_cast<uint8_t>(v);  // C cast truncates toward zero
    }
  }
  delete[] acc;
}

}  // extern "C"
