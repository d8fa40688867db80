// Baseline JPEG entropy decode + IDCT core (from the ITU T.81 spec).
//
// The framework's equivalent of the reference's vendored stb JPEG decoder
// (stb_image.h, used at full_TB.h:107).  Python (io/jpeg.py) parses the
// marker stream and hands this function the entropy-coded bytes plus the
// derived tables; this function performs the per-MCU Huffman decode,
// dequantization, 8x8 float IDCT, level shift, and writes each
// component's plane at its natural (sub)sampled resolution.  Chroma
// upsampling and color conversion happen back in NumPy.
//
// Scope: baseline DCT (SOF0), interleaved single scan, up to 4
// components, restart markers.  Returns 0 on success, negative on error.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// zigzag index -> natural (row-major) index
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct BitReader {
  const uint8_t* data;
  long len;
  long pos = 0;
  uint32_t acc = 0;
  int bits = 0;
  bool hit_marker = false;

  explicit BitReader(const uint8_t* d, long n) : data(d), len(n) {}

  // Refill so that at least `need` bits are available (pads with zeros at
  // the end of the stream, as the spec's decoder does).
  void refill(int need) {
    while (bits < need) {
      int byte = 0;
      if (pos < len && !hit_marker) {
        byte = data[pos++];
        if (byte == 0xFF) {
          int next = pos < len ? data[pos] : 0xD9;
          if (next == 0x00) {
            pos++;  // stuffed 0xFF
          } else {
            // real marker (EOI or unexpected): stop consuming
            hit_marker = true;
            pos--;  // leave the 0xFF in place
            byte = 0;
          }
        }
      }
      acc = (acc << 8) | (uint32_t)byte;
      bits += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    refill(n);
    int v = (int)((acc >> (bits - n)) & ((1u << n) - 1));
    bits -= n;
    return v;
  }

  int peek16() {
    refill(16);
    return (int)((acc >> (bits - 16)) & 0xFFFF);
  }

  void drop(int n) { bits -= n; }

  // Align to byte + skip an RST marker.
  bool restart() {
    bits = 0;
    acc = 0;
    hit_marker = false;
    // find FFD0..FFD7
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
        pos += 2;
        return true;
      }
      pos++;
    }
    return false;
  }
};

struct Huff {
  // spec-style decode tables per code length 1..16
  int mincode[17];
  int maxcode[18];
  int valptr[17];
  uint8_t values[256];

  void build(const int32_t* counts, const int32_t* vals) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      maxcode[l] = code - 1;
      for (int i = 0; i < counts[l - 1]; i++, k++) values[k] = (uint8_t)vals[k];
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
  }

  int decode(BitReader& br) const {
    br.refill(16);
    int code = 0;
    for (int l = 1; l <= 16; l++) {
      code = (code << 1) | br.get_bits(1);
      if (code <= maxcode[l]) return values[valptr[l] + code - mincode[l]];
    }
    return -1;  // invalid code
  }
};

inline int extend(int v, int n) {
  // T.81 F.2.2.1 EXTEND
  return (n && v < (1 << (n - 1))) ? v - (1 << n) + 1 : v;
}

// Simple separable float IDCT (exact enough: within 1 LSB of libjpeg)
void idct8x8(const float* in, float* out) {
  static float c[8][8];
  static bool init = false;
  if (!init) {
    for (int k = 0; k < 8; k++)
      for (int x = 0; x < 8; x++) {
        float ck = k == 0 ? std::sqrt(0.125f) : 0.5f;
        c[k][x] = ck * std::cos((2 * x + 1) * k * (float)M_PI / 16.0f);
      }
    init = true;
  }
  float tmp[64];
  for (int u = 0; u < 8; u++) {  // rows: 1-D idct over columns index v
    for (int x = 0; x < 8; x++) {
      float s = 0;
      for (int v = 0; v < 8; v++) s += in[u * 8 + v] * c[v][x];
      tmp[u * 8 + x] = s;
    }
  }
  for (int x = 0; x < 8; x++) {
    for (int y = 0; y < 8; y++) {
      float s = 0;
      for (int u = 0; u < 8; u++) s += tmp[u * 8 + x] * c[u][y];
      out[y * 8 + x] = s;
    }
  }
}

}  // namespace

extern "C" int jpeg_decode_scan(
    const uint8_t* entropy, long entropy_len,
    int ncomp,
    const int32_t* comp,        // per comp: h, v, qt, dc_tbl, ac_tbl  (5 ints)
    const int32_t* huff_counts, // (8, 16)  tables 0-3 DC, 4-7 AC
    const int32_t* huff_values, // (8, 256)
    const int32_t* quant,       // (4, 64) zigzag order
    int mcu_cols, int mcu_rows,
    int restart_interval,
    uint8_t** planes,           // ncomp pointers, plane i: (mcu_rows*v*8, mcu_cols*h*8)
    const int32_t* plane_stride // ncomp strides (bytes per row)
) {
  Huff tables[8];
  for (int t = 0; t < 8; t++)
    tables[t].build(huff_counts + t * 16, huff_values + t * 256);

  BitReader br(entropy, entropy_len);
  int pred[4] = {0, 0, 0, 0};
  float coef[64], pix[64];
  long mcu_count = 0;

  for (int my = 0; my < mcu_rows; my++) {
    for (int mx = 0; mx < mcu_cols; mx++) {
      if (restart_interval && mcu_count && mcu_count % restart_interval == 0) {
        if (!br.restart()) return -2;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      mcu_count++;
      for (int ci = 0; ci < ncomp; ci++) {
        int H = comp[ci * 5 + 0], V = comp[ci * 5 + 1];
        const int32_t* qt = quant + comp[ci * 5 + 2] * 64;
        const Huff& dc = tables[comp[ci * 5 + 3]];
        const Huff& ac = tables[4 + comp[ci * 5 + 4]];
        for (int by = 0; by < V; by++) {
          for (int bx = 0; bx < H; bx++) {
            std::memset(coef, 0, sizeof(coef));
            int t = dc.decode(br);
            if (t < 0 || t > 15) return -3;  // DC magnitude is <= 15 bits
            int diff = t ? extend(br.get_bits(t), t) : 0;
            pred[ci] += diff;
            coef[0] = (float)(pred[ci] * qt[0]);
            int k = 1;
            while (k < 64) {
              int rs = ac.decode(br);
              if (rs < 0) return -4;
              int r = rs >> 4, s = rs & 15;
              if (s == 0) {
                if (r == 15) { k += 16; continue; }  // ZRL
                break;                               // EOB
              }
              k += r;
              if (k > 63) return -5;
              int v = extend(br.get_bits(s), s);
              coef[kZigzag[k]] = (float)(v * qt[k]);
              k++;
            }
            idct8x8(coef, pix);
            int px0 = (mx * H + bx) * 8;
            int py0 = (my * V + by) * 8;
            uint8_t* plane = planes[ci];
            long stride = plane_stride[ci];
            for (int y = 0; y < 8; y++) {
              uint8_t* row = plane + (long)(py0 + y) * stride + px0;
              for (int x = 0; x < 8; x++) {
                float v = pix[y * 8 + x] + 128.0f;
                int iv = (int)std::lround(v);
                row[x] = (uint8_t)(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
              }
            }
          }
        }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Progressive (SOF2) support — T.81 Annex G.  Coefficients accumulate across
// scans in per-component int32 buffers, one 64-entry ZIGZAG-ordered block per
// 8x8 block on the MCU-padded grid; jpeg_finish_prog dequantizes + IDCTs once
// all scans have been applied.  stb_image decodes progressive (the reference
// ingests such files through it), so this closes that parity gap.

extern "C" int jpeg_decode_prog_scan(
    const uint8_t* entropy, long entropy_len,
    int ncomp_scan,
    const int32_t* scomp,       // per scan comp (8 ints):
                                //   H, V, dc_tbl, ac_tbl,
                                //   grid_w (padded stride, blocks),
                                //   bw, bh (component's true block dims),
                                //   unused
    const int32_t* huff_counts, // (8, 16)  tables 0-3 DC, 4-7 AC
    const int32_t* huff_values, // (8, 256)
    int mcu_cols, int mcu_rows,
    int restart_interval,
    int Ss, int Se, int Ah, int Al,
    int32_t** coeffs            // ncomp_scan pointers, each block grid
) {
  Huff tables[8];
  for (int t = 0; t < 8; t++)
    tables[t].build(huff_counts + t * 16, huff_values + t * 256);

  BitReader br(entropy, entropy_len);
  int pred[4] = {0, 0, 0, 0};
  long eobrun = 0;
  long unit_count = 0;

  // one 8x8 block of one component, at zigzag-ordered coef pointer
  auto decode_dc = [&](int ci, int32_t* c) -> int {
    if (Ah == 0) {  // first DC scan
      const Huff& dc = tables[scomp[ci * 8 + 2]];
      int t = dc.decode(br);
      if (t < 0 || t > 15) return -3;  // DC magnitude is <= 15 bits
      int diff = t ? extend(br.get_bits(t), t) : 0;
      pred[ci] += diff;
      c[0] = pred[ci] << Al;
    } else {  // DC refinement: one appended bit
      if (br.get_bits(1)) c[0] |= (1 << Al);
    }
    return 0;
  };

  auto decode_ac = [&](int ci, int32_t* c) -> int {
    const Huff& ac = tables[4 + scomp[ci * 8 + 3]];
    if (Ah == 0) {  // first AC scan for this band
      if (eobrun > 0) { eobrun--; return 0; }
      int k = Ss;
      while (k <= Se) {
        int rs = ac.decode(br);
        if (rs < 0) return -4;
        int r = rs >> 4, s = rs & 15;
        if (s == 0) {
          if (r < 15) {  // EOBn
            eobrun = (1L << r) - 1;
            if (r) eobrun += br.get_bits(r);
            break;
          }
          k += 16;  // ZRL
        } else {
          k += r;
          if (k > Se) return -5;
          c[k] = extend(br.get_bits(s), s) * (1 << Al);
          k++;
        }
      }
    } else {  // AC refinement (G.1.2.3)
      int bit = 1 << Al;
      int k = Ss;
      if (eobrun == 0) {
        while (k <= Se) {
          int rs = ac.decode(br);
          if (rs < 0) return -4;
          int r = rs >> 4, s = rs & 15;
          int newval = 0;
          if (s == 0) {
            if (r < 15) {
              eobrun = (1L << r);
              if (r) eobrun += br.get_bits(r);
              break;  // remainder handled by the eobrun pass below
            }
            // r == 15: advance past 16 zero-history coefficients
          } else {
            if (s != 1) return -6;  // refinement magnitudes are 1 bit
            newval = br.get_bits(1) ? bit : -bit;
          }
          while (k <= Se) {
            int32_t& cv = c[k];
            if (cv != 0) {
              // correction bit for every nonzero-history coefficient
              if (br.get_bits(1) && (cv & bit) == 0)
                cv += (cv > 0) ? bit : -bit;
            } else {
              if (r == 0) {
                if (s) c[k] = newval;
                k++;
                break;
              }
              r--;
            }
            k++;
          }
        }
      }
      if (eobrun > 0) {
        // within an EOB run only correction bits are coded
        while (k <= Se) {
          int32_t& cv = c[k];
          if (cv != 0 && br.get_bits(1) && (cv & bit) == 0)
            cv += (cv > 0) ? bit : -bit;
          k++;
        }
        eobrun--;
      }
    }
    return 0;
  };

  auto maybe_restart = [&]() -> int {
    if (restart_interval && unit_count && unit_count % restart_interval == 0) {
      if (!br.restart()) return -2;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    unit_count++;
    return 0;
  };

  if (ncomp_scan > 1) {
    // interleaved scan: DC only (T.81 G.1.1.1.1), MCU order
    if (Ss != 0) return -7;
    for (int my = 0; my < mcu_rows; my++)
      for (int mx = 0; mx < mcu_cols; mx++) {
        int rc = maybe_restart();
        if (rc) return rc;
        for (int ci = 0; ci < ncomp_scan; ci++) {
          int H = scomp[ci * 8 + 0], V = scomp[ci * 8 + 1];
          int gw = scomp[ci * 8 + 4];
          for (int by = 0; by < V; by++)
            for (int bx = 0; bx < H; bx++) {
              long bi = (long)(my * V + by) * gw + (mx * H + bx);
              rc = decode_dc(ci, coeffs[ci] + bi * 64);
              if (rc) return rc;
            }
        }
      }
  } else {
    // non-interleaved: the component's own block raster (no MCU padding)
    int gw = scomp[4], bw = scomp[5], bh = scomp[6];
    for (int by = 0; by < bh; by++)
      for (int bx = 0; bx < bw; bx++) {
        int rc = maybe_restart();
        if (rc) return rc;
        int32_t* c = coeffs[0] + ((long)by * gw + bx) * 64;
        rc = Ss == 0 ? decode_dc(0, c) : decode_ac(0, c);
        if (rc) return rc;
      }
  }
  return 0;
}

extern "C" int jpeg_finish_prog(
    const int32_t* coeff,   // (blocks_h * grid_w) blocks, zigzag order
    const int32_t* qt,      // 64, zigzag order
    int grid_w, int blocks_w, int blocks_h,
    uint8_t* plane, long stride
) {
  float coefs[64], pix[64];
  for (int by = 0; by < blocks_h; by++) {
    for (int bx = 0; bx < blocks_w; bx++) {
      const int32_t* c = coeff + ((long)by * grid_w + bx) * 64;
      std::memset(coefs, 0, sizeof(coefs));
      for (int k = 0; k < 64; k++)
        coefs[kZigzag[k]] = (float)(c[k] * qt[k]);
      idct8x8(coefs, pix);
      for (int y = 0; y < 8; y++) {
        uint8_t* row = plane + (long)(by * 8 + y) * stride + bx * 8;
        for (int x = 0; x < 8; x++) {
          float v = pix[y * 8 + x] + 128.0f;
          int iv = (int)std::lround(v);
          row[x] = (uint8_t)(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
        }
      }
    }
  }
  return 0;
}
