"""Where the time of the redesigned kernels goes, on the H100.

    python -m lanczos_torch.tools.probe_kernels [fused] [shift] [sweep] [phase] [interleaved]

(``stream`` and ``window`` are the two halves of ``phase``.)

Each probe is the production source (``csrc/fused_resample.cu``,
``csrc/shift_resample.cu`` or ``csrc/phase_resample.cu``) with one piece of
text substituted, built by ``nvcc`` into a library of its own and timed
beside the production kernel, through the same launch arguments: the fused
kernel and kernel 2 at 4K→8K (3 planes of 2160×3840 → 4320×7680), v1 at
its three full-width shapes (Lanczos-3, uniform noise from
``numpy.random.default_rng(0)``).  A probe's output is wrong by design;
only its time and its registers are read.

``fused`` (4K→8K linear fp32, fp32 dering and bf16, 1440p→4K linear fp32:
the 2/1 and 3/2 plans of the benchmark's cells, on 3 planes; and the ring's
interleaved form on four RGB frames at both, ms a frame), probes of the
pipelined kernel:

- the timeline: ``empty`` returns at once (what launching the persistent
  grid costs), ``loads`` runs the producer alone (its consumers wait for each
  stage and hand it back, with no passes and no stores), ``nostore`` skips
  only the TMA stores of the staged tiles;
- the products: ``novert``, ``nohoriz`` and ``noboth`` run zero window
  steps (epilogues, barriers, loads and stores stay);
- the vertical pass: ``rows`` is the pass as it was before its swapped
  lanes, vector stores and paired bf16 rounding (16 row groups of one
  column group a half-warp, each column's four sums stored as a C++
  ``float4``, which ptxas splits into four 4-byte stores), with
  ``rows_novert``, ``rows_nohoriz`` and ``rows_noboth``; ``f4store`` is
  production with the ``float4`` stores back; ``rowmap`` production with
  16 row groups of one column group a half-warp again; ``round1``
  production rounding the bf16 intermediate one value at a time;
  ``lanes44`` with 4 row groups of 4 column groups a half-warp (band loads
  without conflicts at 2/1, stores two-way; plans of 16 row groups only);
  and designs that lost: ``pairs`` (a warp a pair of row groups over up to
  96 columns, three a lane, the pair's windows walked as their union so
  that each band row is converted once for both; the intermediate's
  columns 4 floats further apart so that its stores miss each other's
  banks), ``pairs_noshare`` (each group walks its own window), and
  ``cols5`` (a thread tile of 5 columns by one row group, so that 256
  tiles fill the threads at 2/1);
- the ring: ``ring1`` and ``ring2`` hold one and two stages (one stage:
  a tile's loads wait for the previous tile's passes), ``blocks1`` and
  ``blocks2`` run one and two blocks an SM (consumers at 232 and 96
  registers), ``staged3`` stages three output tiles a block (two stages),
  ``tile`` forces the one-tile-a-block kernel on the same launch;
  ``unroll_h2`` and ``unroll_v4`` unroll the step loops further.

``interleaved``: the ring on a batch of four RGB and of four RGBA frames
(``quality4k-batch4-upscale``'s batch at 3/2, and 4K→8K at 2/1): the planar
ring on their planes, then the ring's interleaved form on the four (B, H, W,
C) frames as they lie, at each block width tried (``INTERLEAVED_BLOCKS``;
the production one is ``resample_cuda.interleaved_block``), each line with
the ring's stages and blocks an SM and whether its bytes equal the planar
ring's.

``shift`` (kernel 2, dering): ``empty``, ``loads``, ``novert``,
``nohoriz``, and ``threads256`` (blocks of 256 threads, three an SM).

``sweep``: the production fused kernel on plans of other row tiles and
column blocks (``plan_at``), at 2/1 and at 3/2, each line with the ring's
stages and blocks an SM (0 and 0: the one-tile-a-block kernel).

``phase`` (v1, fp32 and bf16): at 8K→480×270 the streamed design's two
kernels: ``empty``, ``loads`` (the copies and the walk without the
arithmetic; for the second kernel the staged band without the tap chains),
rings of 2 and 4 stages, stages of 16 and 64 rows, the row loop unrolled by
2 and 8 and blocks of 2 and 4 warps for the first, 16 band loads in flight a
thread instead of 4 and blocks of 8 and 32 columns (run-time arguments)
for the second, and the first kernel at other chunks of output rows (a
run-time argument); at
1440p→4K and 2160×2880→4K the window design: ``empty``, ``loads``,
``novert``, ``nohoriz``, ``blocks5`` / ``blocks6`` (102 / 85 registers), and
its run-time form on the same plan; and at all three the generic design
forced, which at the thumbnail is also the one-kernel alternative to the
streamed design's two (a tile a block, band and intermediate in shared
memory).

Times are CUDA events around 50 direct calls of the library function after
5 warm-up calls (the Python wrapper is not in the loop), ms per 3-plane
frame, printed with the card's name and power limit and ``nvcc -Xptxas -v``'s
registers and spills of every probe.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

from lanczos_torch.core.config import ResampleConfig
from lanczos_torch.ops import _build
from lanczos_torch.ops import resample_cuda as rc
from lanczos_torch.ops import resample_phase_cuda as rp
from lanczos_torch.ops import resample_shift_cuda as rs
from lanczos_torch.tools.ablate_fused import FRAME_IN, card

_NO_STEPS_V = ("for (int s = 0; s < g.win_v; ++s)", "for (int s = 0; s < 0; ++s)")
_NO_STEPS_H = ("for (int s = 0; s < g.win_h; ++s)", "for (int s = 0; s < 0; ++s)")
_ENTRY_F = "  extern __shared__ uint8_t ring_smem[];"
_ENTRY_S = "  extern __shared__ uint4 smem16[];\n  const int s = S > 0 ? S : g.s"
_RETURN = "  if (g.H > 0) return;\n"
_NEVER = "if (g.H < 0) "  # false at run time: the code stays, its work does not run
_VERT = "      vertical_pass<BF16, DERING, QUANT>(tid, st,"
_HORIZ = "        horizontal_pass<DERING, false>(tid, midT,"  # the planar ring's
_STORE = "        for (int q = 0; q < 4; ++q)\n          tma_store_3d("
_NO_STORE = (_STORE, "        for (int q = 0; q < 4 * (g.H < 0); ++q)\n          tma_store_3d(")
_RING = "const Ring R = ring_layout(g, dering != 0, stages);"

# the intermediate's rounding one value at a time, as the vertical pass had it before it rounded
# two at once (the designs below call it)
_ROUND_MID = r"""template <bool BF16>
__device__ __forceinline__ float round_mid(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

"""
# The vertical pass before its swapped lanes, vector stores and paired bf16 rounding, for the
# "rows" probes
_ROWS_V = _ROUND_MID + r"""// thread tile = 8 intermediate columns x one group of 4 tile rows, row groups fastest
template <bool BF16, bool DERING, bool QUANT>
__device__ __forceinline__ void vertical_pass_rows(int tid, const uint8_t* band,
                                                   const float4* wv_s, const int* base_v_s,
                                                   const int* cv_s, float* midT, int joff,
                                                   const Geometry& g) {
  const int tile_p = g.tile_p, bw = g.bw, nrg_v = tile_p >> 2;
  float acc[8][4];
  for (int t = tid; t < (g.mw >> 3) * nrg_v; t += kThreads) {
    int jg, rg;
    split(t, nrg_v, g.nrg_v_lg, jg, rg);
    const uint8_t* bcol = band + joff + 8 * jg;
    const uint8_t* bp = bcol + base_v_s[rg] * bw;
    const float4* wp = wv_s + rg;
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
#pragma unroll 2
    for (int s = 0; s < g.win_v; ++s) {
      float a[8];
      load8_u8(bp + s * bw, a);
      fma_tile(a, wp[s * nrg_v], acc);
    }
    if (DERING) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float lo[8], hi[8];
        load8_u8(bcol + cv_s[4 * rg + n] * bw, lo);
        load8_u8(bcol + cv_s[tile_p + 4 * rg + n] * bw, hi);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[m][n] = clamp_between(acc[m][n], lo[m], hi[m]);
      }
    }
    float* mcol = midT + 8 * jg * tile_p + 4 * rg;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v[n] = acc[m][n];
        if (QUANT) v[n] = truncf(fminf(fmaxf(v[n], 0.f), 255.f));
        v[n] = round_mid<BF16>(v[n]);
      }
      *reinterpret_cast<float4*>(mcol + m * tile_p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

"""
# Designs of the vertical pass that lost (PERF.md §6), for the "pairs" and "cols5"
# probes: a warp a pair of row groups over a chunk of columns, the pair's windows walked as
# their union (the intermediate's columns tile_p + 4 floats apart, _MID_PAD)
_PAIRS_V = _ROUND_MID + r"""// a vertical thread tile's three bytes of one band row as floats: the pair at pc (2-byte
// aligned) and the byte at bc
__device__ __forceinline__ void load3_u8(const uint8_t* row, int pc, int bc, float (&a)[3]) {
  const unsigned pair = *reinterpret_cast<const uint16_t*>(row + pc), byte = row[bc];
  a[0] = byte_to_float<0>(pair), a[1] = byte_to_float<1>(pair), a[2] = byte_to_float<0>(byte);
}

__device__ __forceinline__ void fma_cols(const float (&a)[3], const float4 w,
                                         float (&acc)[3][4]) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    acc[m][0] = fmaf(a[m], w.x, acc[m][0]);
    acc[m][1] = fmaf(a[m], w.y, acc[m][1]);
    acc[m][2] = fmaf(a[m], w.z, acc[m][2]);
    acc[m][3] = fmaf(a[m], w.w, acc[m][3]);
  }
}

template <bool BF16, bool DERING, bool QUANT>
__device__ __forceinline__ void vertical_pass_pairs(int tid, const uint8_t* band, const float4* wv_s,
                                              const int* base_v_s, const int* cv_s,
                                              float* midT, int joff, const Geometry& g) {
  const int tile_p = g.tile_p, bw = g.bw, nrg_v = tile_p >> 2, pairs = nrg_v >> 1;
  const int win = g.win_v, lane = tid & 31, mp = tile_p + 4;
  const int v_chunks = max((g.mw + 95) / 96, min((8 + pairs - 1) / pairs, (g.mw + 31) / 32));
  const int v_cw = ((g.mw + v_chunks - 1) / v_chunks + 1) / 2 * 2;
  for (int t = tid >> 5; t < pairs * v_chunks; t += kWarps) {
    const int chunk = t / pairs, rg = 2 * (t - chunk * pairs);
    const int c0 = chunk * v_cw, cw = min(v_cw, g.mw - c0);
    const bool in[3] = {2 * lane < cw, 2 * lane + 1 < cw, 64 + lane < cw};
    const int pc = in[0] ? 2 * lane : 0, bc = in[2] ? 64 + lane : 0;  // in the chunk
    const uint8_t* bcol = band + joff + c0;
    const int b0 = base_v_s[rg], d = base_v_s[rg + 1] - b0;
    const int e = d >= 0 && d < win ? d : win;  // the steps of rg before rg + 1's window
    const float4* wp = wv_s + rg;
    float acc[2][3][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[h][m][n] = 0.f;
    const uint8_t* bp = bcol + b0 * bw;
#pragma unroll 1
    for (int s = 0; s < e; ++s) {  // rg alone
      float a[3];
      load3_u8(bp + s * bw, pc, bc, a);
      fma_cols(a, wp[s * nrg_v], acc[0]);
    }
#pragma unroll 2
    for (int s = e; s < win; ++s) {  // both
      float a[3];
      load3_u8(bp + s * bw, pc, bc, a);
      fma_cols(a, wp[s * nrg_v], acc[0]);
      fma_cols(a, wp[(s - d) * nrg_v + 1], acc[1]);
    }
    bp += d * bw;
#pragma unroll 1
    for (int s = win - e; s < win; ++s) {  // rg + 1 alone
      float a[3];
      load3_u8(bp + s * bw, pc, bc, a);
      fma_cols(a, wp[s * nrg_v + 1], acc[1]);
    }
    if (DERING) {  // clamp to the band rows of tile row 4 (rg + h) + n's central taps
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float lo[3], hi[3];
          load3_u8(bcol + cv_s[4 * (rg + h) + n] * bw, pc, bc, lo);
          load3_u8(bcol + cv_s[tile_p + 4 * (rg + h) + n] * bw, pc, bc, hi);
#pragma unroll
          for (int m = 0; m < 3; ++m) acc[h][m][n] = clamp_between(acc[h][m][n], lo[m], hi[m]);
        }
    }
    const int col[3] = {2 * lane, 2 * lane + 1, 64 + lane};
    float* mcol = midT + c0 * mp + 4 * rg;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      if (!in[m]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          v[n] = acc[h][m][n];
          if (QUANT) v[n] = truncf(fminf(fmaxf(v[n], 0.f), 255.f));
          v[n] = round_mid<BF16>(v[n]);
        }
        *reinterpret_cast<float4*>(mcol + col[m] * mp + 4 * h) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

"""
# a thread tile of 5 columns (a word and a byte) by one row group: 256 tiles at 2/1
_COLS5_V = _ROUND_MID + r"""
__device__ __forceinline__ void load5_u8(const uint8_t* row, int wc, int bc, float (&a)[5]) {
  const unsigned w4 = *reinterpret_cast<const unsigned*>(row + wc), b1 = row[bc];
  a[0] = byte_to_float<0>(w4), a[1] = byte_to_float<1>(w4), a[2] = byte_to_float<2>(w4);
  a[3] = byte_to_float<3>(w4), a[4] = byte_to_float<0>(b1);
}

template <bool BF16, bool DERING, bool QUANT>
__device__ __forceinline__ void vertical_pass_cols5(int tid, const uint8_t* band,
                                                    const float4* wv_s, const int* base_v_s,
                                                    const int* cv_s, float* midT, int joff,
                                                    const Geometry& g) {
  const int tile_p = g.tile_p, bw = g.bw, nrg_v = tile_p >> 2;
  const int tg = (g.mw + 4) / 5, wordc = 4 * tg;  // lanes a row group; the columns of their words
  float acc[5][4];
  for (int t = tid; t < nrg_v * tg; t += kThreads) {
    const int j = t / nrg_v, rg = t - j * nrg_v;
    const bool has_b = wordc + j < g.mw;
    const int bc = has_b ? wordc + j : 0;
    const uint8_t* bp = band + joff + base_v_s[rg] * bw;
    const float4* wp = wv_s + rg;
#pragma unroll
    for (int m = 0; m < 5; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
#pragma unroll 2
    for (int s = 0; s < g.win_v; ++s) {
      float a[5];
      load5_u8(bp + s * bw, 4 * j, bc, a);
      const float4 w = wp[s * nrg_v];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        acc[m][0] = fmaf(a[m], w.x, acc[m][0]);
        acc[m][1] = fmaf(a[m], w.y, acc[m][1]);
        acc[m][2] = fmaf(a[m], w.z, acc[m][2]);
        acc[m][3] = fmaf(a[m], w.w, acc[m][3]);
      }
    }
    if (DERING) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float lo[5], hi[5];
        load5_u8(band + joff + cv_s[4 * rg + n] * bw, 4 * j, bc, lo);
        load5_u8(band + joff + cv_s[tile_p + 4 * rg + n] * bw, 4 * j, bc, hi);
#pragma unroll
        for (int m = 0; m < 5; ++m) acc[m][n] = clamp_between(acc[m][n], lo[m], hi[m]);
      }
    }
    const int col[5] = {4 * j, 4 * j + 1, 4 * j + 2, 4 * j + 3, wordc + j};
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      if (m == 4 && !has_b) continue;
      float v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v[n] = acc[m][n];
        if (QUANT) v[n] = truncf(fminf(fmaxf(v[n], 0.f), 255.f));
        v[n] = round_mid<BF16>(v[n]);
      }
      st_shared_v4(midT + col[m] * tile_p + 4 * rg, v[0], v[1], v[2], v[3]);
    }
  }
}
"""
_HORIZ_DOC = "// steps 3 and 4 (into the staged tile) of one tile."
_VERT_TILE = "  vertical_pass<BF16, DERING, QUANT>(threadIdx.x, band,"
# the intermediate's columns tile_p + 4 floats apart, in the horizontal pass and both kernels'
# shared memory
_MID_PAD = [
    ("step = C * tile_p;", "step = C * (tile_p + 4);"),
    ("const float* mrow = midT + (dj + ch) * tile_p", "const float* mrow = midT + (dj + ch) * (tile_p + 4)"),
    ("(midT + g.mw * tile_p);", "(midT + g.mw * (tile_p + 4));"),
    ("sizeof(float) * (size_t)g.mw * g.tile_p +", "sizeof(float) * (size_t)g.mw * (g.tile_p + 4) +"),
    ("R.mid_off + 4 * g.mw * g.tile_p;", "R.mid_off + 4 * g.mw * (g.tile_p + 4);"),
]


def _vertical(name: str, text: str, extra: tuple = ()) -> list:
    """The substitutions that put ``text``, which defines ``vertical_pass_<name>``, in the
    place of the production vertical pass in both kernels."""
    return [(_HORIZ_DOC, text + _HORIZ_DOC), (_VERT, _VERT.replace("pass<", f"pass_{name}<")),
            (_VERT_TILE, _VERT_TILE.replace("pass<", f"pass_{name}<")), *extra]


def _rows(steps: str = "g.win_v") -> list:
    """``_ROWS_V`` in the place of the production vertical pass, its step
    loop run ``steps`` times."""
    return _vertical("rows", _ROWS_V.replace("s < g.win_v; ++s) {\n      float a[8];",
                                             f"s < {steps}; ++s) {{\n      float a[8];"))


_V4_STORE = "      st_shared_v4(mcol + m * tile_p, v[0], v[1], v[2], v[3]);"
_SWAP = "  const bool swap = (nrg_v & 15) == 0;\n"
_LOOP = ("  for (int t = tid; t < ((n + 31) & ~31); t += kThreads) {  // whole warps: the swap stays in one\n"
         "    const int u = swap ? (t & ~24) | (t >> 1 & 8) | (t << 1 & 16) : t;\n")
# a warp a block of 8 row groups by 4 column groups, a half-warp 4 by 4 (tile_p 64: 16 row groups)
_LANES44 = ("  for (int t = tid; t < 64 * (((g.mw >> 3) + 3) >> 2); t += kThreads) {\n"
            "    const int l = t & 31, bw8 = t >> 5;\n"
            "    const int rg4 = (bw8 & 1) * 8 + (l & 3) + (l >> 4 << 2), jg4 = (bw8 >> 1) * 4 + (l >> 2 & 3);\n"
            "    const int u = jg4 < (g.mw >> 3) ? jg4 * nrg_v + rg4 : n;\n")

# name -> [(text in the production source, its replacement), ...]
FUSED_PROBES = {
    "empty": [(_ENTRY_F, _RETURN + _ENTRY_F)],
    "loads": [(_VERT, _VERT.replace("vertical", _NEVER + "vertical")),
              (_HORIZ, _HORIZ.replace("horizontal", _NEVER + "horizontal")), _NO_STORE],
    "nostore": [_NO_STORE],
    "novert": [_NO_STEPS_V],
    "nohoriz": [_NO_STEPS_H],
    "noboth": [_NO_STEPS_V, _NO_STEPS_H],
    "ring1": [(_RING, _RING.replace("stages);", "1);"))],
    "ring2": [(_RING, _RING.replace("stages);", "2);"))],
    "blocks1": [("__launch_bounds__(kRingThreads, kRingBlocks)", "__launch_bounds__(kRingThreads, 1)"),
                ("setmaxnreg.inc.sync.aligned.u32 72;", "setmaxnreg.inc.sync.aligned.u32 232;"),
                ("min(R.total, blocks * multiprocessors())", "min(R.total, multiprocessors())")],
    "blocks2": [("__launch_bounds__(kRingThreads, kRingBlocks)", "__launch_bounds__(kRingThreads, 2)"),
                ("setmaxnreg.inc.sync.aligned.u32 72;", "setmaxnreg.inc.sync.aligned.u32 96;"),
                ("min(R.total, blocks * multiprocessors())", "min(R.total, 2 * multiprocessors())")],
    "staged3": [("constexpr int kStaged = 2;", "constexpr int kStaged = 3;"),
                (_RING, _RING.replace("stages);", "2);"))],
    "tile": [("  if (stages > 0) {", "  if (stages < 0) {")],
    "unroll_h2": [("#pragma unroll 1\n    " + _NO_STEPS_H[0], "#pragma unroll 2\n    " + _NO_STEPS_H[0])],
    "unroll_v4": [("#pragma unroll 2\n    " + _NO_STEPS_V[0], "#pragma unroll 4\n    " + _NO_STEPS_V[0])],
    "rows": _rows(),
    "rows_novert": _rows("0"),
    "rows_nohoriz": _rows() + [_NO_STEPS_H],
    "rows_noboth": _rows("0") + [_NO_STEPS_H],
    "f4store": [(_V4_STORE, "      *reinterpret_cast<float4*>(mcol + m * tile_p) = "
                            "make_float4(v[0], v[1], v[2], v[3]);")],
    "rowmap": [(_SWAP, "  const bool swap = false;  // 16 row groups of one column group a half-warp\n")],
    "lanes44": [(_LOOP, _LANES44)],
    "round1": [("// jnp.clip(v, min(a, b), max(a, b))", _ROUND_MID + "// jnp.clip(v, min(a, b), max(a, b))"),
               ("      round_mid2<BF16>(v[0], v[1]);\n      round_mid2<BF16>(v[2], v[3]);\n",
                "#pragma unroll\n      for (int n = 0; n < 4; ++n) v[n] = round_mid<BF16>(v[n]);\n")],
    "pairs": _vertical("pairs", _PAIRS_V, tuple(_MID_PAD)),
    "pairs_noshare": _vertical("pairs", _PAIRS_V.replace("const int e = d >= 0 && d < win ? d : win;",
                                                         "const int e = win;"), tuple(_MID_PAD)),
    "cols5": _vertical("cols5", _COLS5_V),
}
SHIFT_PROBES = {
    "empty": [(_ENTRY_S, _RETURN + _ENTRY_S)],
    "loads": [("  cp_async_wait_all();\n  __syncthreads();\n",
               "  cp_async_wait_all();\n  __syncthreads();\n" + _RETURN)],
    "novert": [("for (int p = 0; p < nv; ++p) {\n          float w[kTaps], o[4][kRun];",
                "for (int p = 0; p < 0; ++p) {\n          float w[kTaps], o[4][kRun];")],
    "nohoriz": [("for (int p = 0; p < nh; ++p) {\n          float w[kTaps], o[2][kRun];",
                 "for (int p = 0; p < 0; ++p) {\n          float w[kTaps], o[2][kRun];")],
    "threads256": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
                   ("__launch_bounds__(kThreads, 6)", "__launch_bounds__(kThreads, 3)")],
}
_ENTRY_W = ("  extern __shared__ uint4 smem16[];\n"
            "  const int taps_v = 2 * g.sv, taps_h = 2 * g.sh;")
_ENTRY_SV = "  constexpr int LW = (LIVE + 3) / 4 * 4;\n  extern __shared__ uint4 smem16[];"
_ENTRY_SH = ("  extern __shared__ float4 smem4[];\n"
             "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
             "  const int es = g.eh | 1;")
_BOUNDS_W = "__launch_bounds__(kWinThreads, 4)"
# library function -> name -> [(text in csrc/phase_resample.cu, its replacement), ...]
PHASE_PROBES = {
    "lanczos_phase_window": {
        "empty": [(_ENTRY_W, _RETURN + _ENTRY_W)],
        "loads": [("  cp_async_wait_all();\n  __syncthreads();\n\n  if constexpr (VA::N > 0) {",
                   "  cp_async_wait_all();\n  __syncthreads();\n" + _RETURN
                   + "  if constexpr (VA::N > 0) {")],
        "novert": [("it < (g.pv / K) * ng; it += kWinThreads", "it < 0; it += kWinThreads")],
        "nohoriz": [("it < (tr >> 1) * ng; it += kWinThreads", "it < 0; it += kWinThreads")],
        "blocks5": [(_BOUNDS_W, "__launch_bounds__(kWinThreads, 5)")],
        "blocks6": [(_BOUNDS_W, "__launch_bounds__(kWinThreads, 6)")],
    },
    "lanczos_phase_stream_v": {
        "empty": [(_ENTRY_SV, _RETURN + _ENTRY_SV)],
        "loads": [("    const int nr = min(kStageRows, nrows - s * kStageRows);",
                   "    const int nr = 0;")],
        "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
        "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
        "rows16": [("constexpr int kStageRows = 32;", "constexpr int kStageRows = 16;")],
        "rows64": [("constexpr int kStageRows = 32;", "constexpr int kStageRows = 64;")],
        "unroll2": [("#pragma unroll 4\n    for (int row = 0; row < nr; ++row) {",
                     "#pragma unroll 2\n    for (int row = 0; row < nr; ++row) {")],
        "unroll8": [("#pragma unroll 4\n    for (int row = 0; row < nr; ++row) {",
                     "#pragma unroll 8\n    for (int row = 0; row < nr; ++row) {")],
        "warps2": [("constexpr int kStreamWarps = 1;", "constexpr int kStreamWarps = 2;")],
        "warps4": [("constexpr int kStreamWarps = 1;", "constexpr int kStreamWarps = 4;")],
    },
    "lanczos_phase_stream_h": {
        "empty": [(_ENTRY_SH, "  if (g.OH > 0) return;\n" + _ENTRY_SH)],
        "loads": [("  __syncthreads();\n  if (lane < rows_n) {",
                   "  __syncthreads();\n  if (g.OH > 0) return;\n  if (lane < rows_n) {")],
        "batch16": [("constexpr int kHBatch = 4; ", "constexpr int kHBatch = 16;")],
    },
}
STREAM_CHUNKS = (14, 18, 23, 27, 30, 34, 39, 45, 68, 135, 270)  # output rows a chunk of the streamed pass
# v1's full-width shapes: name, input, output
PHASE_SHAPES = (("8K->480x270", (4320, 7680), (270, 480)),
                ("1440p->4K", (1440, 2560), (2160, 3840)),
                ("2160x2880->4K", (2160, 2880), (2160, 3840)))
SWEEP = ((64, 128), (64, 256), (128, 128), (96, 128), (32, 256), (32, 128), (128, 256))
SWEEP_32 = ((64, 96), (64, 48), (128, 96), (32, 96), (64, 144), (64, 192))  # 3/2: multiples of 48
QUALITY_IN = (1440, 2560)  # FSR Quality, 1440p -> 4K
# channels -> block widths: staged rows of 96, 144, 192 and 240 bytes (RGB), 128, 192, 256 (RGBA)
INTERLEAVED_BLOCKS = {3: (32, 48, 64, 80), 4: (32, 48, 64)}
SOURCES = {"lanczos_fused_resample": "fused_resample.cu",
           "lanczos_shift_resample": "shift_resample.cu",
           **{fn: "phase_resample.cu" for fn in (
               "lanczos_phase_resample", "lanczos_phase_window",
               "lanczos_phase_stream_v", "lanczos_phase_stream_h")}}


def probe_source(function: str, subs: list) -> str:
    """The production source of ``function`` with every substitution made;
    raises where a probe's text is no longer in the source."""
    src = (_build.CSRC / SOURCES[function]).read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{SOURCES[function]}: expected once: {old!r}")
        src = src.replace(old, new)
    return src


def build_probe(function: str, subs: list, workdir: Path, name: str):
    """Compile a probe; returns its library function and what ``ptxas``
    said of registers and spills."""
    cu = workdir / f"{name}.cu"
    cu.write_text(probe_source(function, subs))
    so = workdir / f"{name}.so"
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
         "-shared", "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on probe {name}:\n{res.stdout}{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in lines if "Used " in ln})
    spills = sorted({ln.strip() for ln in lines
                     if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln})
    fn = getattr(ctypes.CDLL(str(so)), function)
    fn.argtypes = getattr(_build.library(), function).argtypes
    fn.restype = ctypes.c_int
    return fn, f"{', '.join(regs)}; spills: {spills or 'none'}"


def launch_args(function: str, call) -> tuple:
    """The arguments ``call()`` passes to the library's ``function``, with
    ``call``'s result, whose memory they point to and which the caller
    keeps for as long as it launches with them."""
    lib, seen = _build.library(), {}

    def spy(*args):
        seen["args"] = args
        return getattr(lib, function)(*args)

    shim = types.SimpleNamespace(
        **{function: spy, "lanczos_cuda_error_string": lib.lanczos_cuda_error_string})
    real = _build.library
    _build.library = lambda: shim
    try:
        out = call()
    finally:
        _build.library = real
    torch.cuda.synchronize()
    return seen["args"], out


def time_ms(fn, args: tuple, iters: int = 50) -> float:
    """Device ms per direct call of ``fn(*args)``."""
    for _ in range(5):
        _build.check(fn(*args))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def frame_cfg(**kw) -> ResampleConfig:
    return ResampleConfig.from_profile("precise", FRAME_IN, scale=(2, 1), a=3, **kw)


def quality_cfg(**kw) -> ResampleConfig:
    return ResampleConfig.from_profile("precise", QUALITY_IN, scale=(3, 2), a=3, **kw)


def ring_of(args: tuple) -> str:
    """The ring's stages and blocks an SM in a fused launch's arguments
    (the two integers before the stream)."""
    return f"ring {args[-3]} stages x {args[-2]} blocks an SM"


def probe_phase(lib, tmp: Path, smi: str, designs=("stream", "window")) -> None:
    """The ``phase`` group: v1's designs at their full-width shapes (only
    the shapes that ``designs`` take)."""
    built = {}  # (function, probe) -> (library function, ptxas summary)

    def probe(function, name):
        if (function, name) not in built:
            built[function, name] = build_probe(
                function, PHASE_PROBES[function][name], tmp, f"{function}_{name}")
        return built[function, name]

    for shape_name, shp, out in PHASE_SHAPES:
        x = torch.from_numpy(
            np.random.default_rng(0).integers(0, 256, (3,) + shp, np.uint8)).cuda()
        for precision in ("fp32", "bf16"):
            cfg = ResampleConfig.from_profile("precise", shp, out_shape=out, a=3,
                                              precision=precision)
            tag = f"phase {shape_name} {precision}"
            ops = rp.PhaseOps(cfg, "cuda")
            if ops.design not in designs:
                continue
            gen = rp.PhaseOps(cfg, "cuda", design="generic")
            a, _out = launch_args("lanczos_phase_resample", lambda: rp.phase_call(gen, x))
            note = " (the one-kernel alternative)" if shape_name.startswith("8K") else ""
            print(f"{tag}: generic design forced{note} "
                  f"{time_ms(lib.lanczos_phase_resample, a):.4f} ms, layout {gen.layout} "
                  f"[{smi}]", flush=True)
            if ops.design == "stream":
                fv, fh = "lanczos_phase_stream_v", "lanczos_phase_stream_h"
                av, mid = launch_args(fv, lambda: rp.stream_v_call(ops, x))
                ah, _out = launch_args(fh, lambda: rp.stream_h_call(ops, mid))
                tv, th = time_ms(getattr(lib, fv), av), time_ms(getattr(lib, fh), ah)
                print(f"{tag}: production stream_v {tv:.4f} + stream_h {th:.4f} = "
                      f"{tv + th:.4f} ms ({av[11]} rows a chunk, layout {ops.layout}) [{smi}]",
                      flush=True)
                for fn, args in ((fv, av), (fh, ah)):
                    for name in PHASE_PROBES[fn]:
                        f, info = probe(fn, name)
                        print(f"{tag}: {fn.removeprefix('lanczos_phase_')} probe {name} "
                              f"{time_ms(f, args):.4f} ms ({info})", flush=True)
                base_h, _ = ops.plan.h.taps(out[1])
                for tc in (8, 32):  # args[11] and [12]: the tile's columns and its band's
                    eh = rp._extent(base_h, tc, 2 * ops.plan.h.support)
                    t = time_ms(getattr(lib, fh), ah[:11] + (tc, eh) + ah[13:])
                    print(f"{tag}: stream_h at {tc} columns a block ({eh} read, "
                          f"{rp.stream_h_smem_bytes(ops.plan, tc, eh)} B) {t:.4f} ms", flush=True)
                for rpc in STREAM_CHUNKS:  # args[11] is the rows of a chunk
                    t = time_ms(getattr(lib, fv), av[:11] + (rpc,) + av[12:])
                    print(f"{tag}: stream_v at {rpc} rows a chunk {t:.4f} ms", flush=True)
            elif ops.design == "window":
                fn = "lanczos_phase_window"
                a, _out = launch_args(fn, lambda: rp.phase_call(ops, x))
                print(f"{tag}: production window {time_ms(getattr(lib, fn), a):.4f} ms "
                      f"(layout {ops.layout}) [{smi}]", flush=True)
                for name in PHASE_PROBES[fn]:
                    f, info = probe(fn, name)
                    print(f"{tag}: window probe {name} {time_ms(f, a):.4f} ms ({info})",
                          flush=True)
                # the run-time form on the same blocks: args[25] is the compile-time flag
                t = time_ms(getattr(lib, fn), a[:25] + (0,) + a[26:])
                print(f"{tag}: window run-time form {t:.4f} ms", flush=True)


def probe_interleaved(lib, smi: str) -> None:
    """The ``interleaved`` group: ms a frame of the planar ring and of the
    interleaved ring at each block width, on batches of four frames."""
    fn = "lanczos_fused_resample"
    for (name, make, shape), c in itertools.product(
            (("3/2", quality_cfg, QUALITY_IN), ("2/1", frame_cfg, FRAME_IN)), INTERLEAVED_BLOCKS):
        cfg = make()
        frames = torch.from_numpy(
            np.random.default_rng(0).integers(0, 256, (4,) + shape + (c,), np.uint8)).cuda()
        planes = frames.permute(0, 3, 1, 2).reshape(4 * c, *shape).contiguous()
        ops = rc.FusedOps(cfg, "cuda")
        a, want = launch_args(fn, lambda: rc.fused_call(ops, planes))
        want = want.reshape(4, c, *cfg.out_shape).permute(0, 2, 3, 1)
        print(f"interleaved {name} C={c}: planar ring {time_ms(getattr(lib, fn), a) / 4:.4f} ms "
              f"a frame (block {ops.plan.cb}), {ring_of(a)} [{smi}]", flush=True)
        for cb in INTERLEAVED_BLOCKS[c]:
            plan = rc.interleaved_plan(cfg, ops.plan.tile_out, c, cb)
            layout = plan and rc.upload_layout(plan, cfg, ops.device, c)
            tag = f"interleaved {name} C={c} block {cb}" + (
                " (production)" if cb == rc.interleaved_block(c) else "")
            if layout is None:
                print(f"{tag}: not on the ring", flush=True)
                continue
            ops_i = rc.FusedOps(cfg, "cuda")
            ops_i.layouts[c] = layout  # this block width in place of the production one
            a, got = launch_args(fn, lambda o=ops_i: rc.upscale_frames(frames, o))
            print(f"{tag}: {time_ms(getattr(lib, fn), a) / 4:.4f} ms a frame, {ring_of(a)}, "
                  f"bytes {'equal' if torch.equal(got, want) else 'DIFFER'}", flush=True)


def probe_fused(lib, x, xq, tmp: Path, smi: str) -> None:
    """The ``fused`` group: the production kernel and every probe of
    :data:`FUSED_PROBES` on 3 planes at 2/1 (linear, dering and bf16) and
    3/2, and on four interleaved RGB frames at both; ms a frame, and whether each
    probe's bytes equal production's (the zero-step probes' cannot)."""
    fn = "lanczos_fused_resample"
    ilv = {name: torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4,) + shape + (3,), np.uint8)).cuda()
        for name, shape in (("2/1", FRAME_IN), ("3/2", QUALITY_IN))}
    runs = {"fp32": (frame_cfg(), x, rc.fused_call, 1),
            "fp32 dering": (frame_cfg(dering=True), x, rc.fused_call, 1),
            "3/2 fp32": (quality_cfg(), xq, rc.fused_call, 1),
            "bf16": (frame_cfg(precision="bf16"), x, rc.fused_call, 1),
            "RGB 2/1": (frame_cfg(), ilv["2/1"], rc.upscale_frames, 4),
            "RGB 3/2": (quality_cfg(), ilv["3/2"], rc.upscale_frames, 4)}
    ops = {name: rc.FusedOps(c, "cuda") for name, (c, *_) in runs.items()}  # kept: the
    # launch arguments point into their tables
    args = {name: launch_args(fn, lambda o=ops[name], img=img, call=call: call(img, o)
                              if call is rc.upscale_frames else call(o, img))
            for name, (_, img, call, _n) in runs.items()}
    want = {}
    for name, (a, out) in args.items():
        t = time_ms(getattr(lib, fn), a) / runs[name][3]
        want[name] = out.clone()
        print(f"fused {name}: production {t:.4f} ms a frame, {ring_of(a)} [{smi}]", flush=True)
    for probe, subs in FUSED_PROBES.items():
        f, info = build_probe(fn, subs, tmp, f"fused_{probe}")
        times = []
        for name, (a, out) in args.items():
            try:
                t = time_ms(f, a) / runs[name][3]
            except RuntimeError as err:  # the one-tile kernel takes no interleaved frames
                times.append(f"{name} fails ({err})")
                continue
            same = "" if torch.equal(out, want[name]) else " (bytes differ)"
            times.append(f"{name} {t:.4f}{same}")
        print(f"fused probe {probe}: {', '.join(times)} ms ({info})", flush=True)


GROUPS = ("fused", "shift", "sweep", "phase", "interleaved", "stream", "window")


def main(argv=None) -> int:
    what = set(sys.argv[1:] if argv is None else argv) or set(GROUPS[:4])
    if what - set(GROUPS):
        print(f"probe_kernels: choose from {', '.join(GROUPS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    lib = _build.library()
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (3,) + FRAME_IN, np.uint8)).cuda()
    xq = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (3,) + QUALITY_IN, np.uint8)).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        if "fused" in what:
            probe_fused(lib, x, xq, Path(tmp), smi)
        if "sweep" in what:
            fn = "lanczos_fused_resample"
            for name, make, img, sweep in (("2/1", frame_cfg, x, SWEEP),
                                           ("3/2", quality_cfg, xq, SWEEP_32)):
                for tile, cb in sweep:
                    plan = rc.plan_at(make(), tile, cb)
                    if plan is None:
                        print(f"fused sweep {name} tile {tile} cb {cb}: no plan", flush=True)
                        continue
                    ops = rc.FusedOps(make(), "cuda", plan)
                    a, _out = launch_args(fn, lambda ops=ops, img=img: rc.fused_call(ops, img))
                    print(f"fused sweep {name} tile {tile} cb {cb} (block {plan.cb}): "
                          f"{time_ms(getattr(lib, fn), a):.4f} ms, {ring_of(a)}, "
                          f"{plan.smem_bytes()} B of shared memory one tile a block [{smi}]",
                          flush=True)
        if "shift" in what:
            fn = "lanczos_shift_resample"
            ops = rc.FusedOps(frame_cfg(dering=True), "cuda", variant="v2")
            a, _out = launch_args(fn, lambda: rs.shift_call(ops.shift, x))
            print(f"shift dering: production {time_ms(getattr(lib, fn), a):.4f} ms [{smi}]",
                  flush=True)
            for probe, subs in SHIFT_PROBES.items():
                f, info = build_probe(fn, subs, Path(tmp), f"shift_{probe}")
                print(f"shift probe {probe}: dering {time_ms(f, a):.4f} ms ({info})", flush=True)
        if "interleaved" in what:
            probe_interleaved(lib, smi)
        designs = {"stream", "window"} & what if "phase" not in what else ("stream", "window")
        if designs:
            probe_phase(lib, Path(tmp), smi, tuple(designs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
