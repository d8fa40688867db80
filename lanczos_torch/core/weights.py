"""Weight-table / banded-operator builders.

The load-bearing idea (reference ``kernel.cpp:50-59``): with a reduced
rational scale N/D, the tap offset ``x = out·D − in·N`` takes only N·2a
distinct values, so 1-D resampling ``out = R · in`` uses a banded matrix R
(band width 2a) whose values come from an (N × 2a) phase table.  Everything
here runs host-side in float64 NumPy at build time; the device only ever
sees small dense tables.

Three builders, copied from ``lanczos_tpu.core.weights`` so that the port
imports no JAX (``tests/test_torch_core.py`` holds them equal to the
originals):

- :func:`banded_weights` — general per-output-row band (indices + weights),
  the semantics anchor used by every backend.
- :func:`phase_table` / :class:`PhaseWeights` — the N-phase compressed form used by the fast
  strided-gather / Pallas paths (interior rows only; edges are corrected by
  the banded form).
- :func:`hls_schedule` / :func:`hls_lut` — bit-faithful reconstruction of
  the reference HLS path's streaming counters (``worker.cpp:138-155``,
  ``170-198``, ``239-275``) and its fixed-point ROM (``kernel.cpp:40-59``),
  flattened into static gather indices so the whole "cyclic buffer + step
  predicate" machine becomes a precomputed index table.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from lanczos_torch.core.config import EdgeMode, reduced_scale
from lanczos_torch.core.filters import get_filter


@dataclasses.dataclass(frozen=True)
class BandedOperator:
    """A banded 1-D resampling operator ``out[y] = Σ_j w[y,j]·in[idx[y,j]]``.

    ``idx`` is always within [0, in_size); out-of-range taps have been
    resolved per the edge mode (weight zeroed for DROP, index clamped for
    CLAMP, mirrored for REFLECT).
    """

    in_size: int
    out_size: int
    a: int
    idx: np.ndarray  # (out, 2a) int32, in [0, in_size)
    weights: np.ndarray  # (out, 2a) float64
    base: np.ndarray  # (out,) int32 — unclipped band start floor(y·D/N)−a+1

    @property
    def taps(self) -> int:
        return 2 * self.a

    def dense(self) -> np.ndarray:
        """Materialize the (out, in) dense matrix (tests / tiny sizes)."""
        R = np.zeros((self.out_size, self.in_size), dtype=np.float64)
        for j in range(self.taps):
            np.add.at(R, (np.arange(self.out_size), self.idx[:, j]), self.weights[:, j])
        return R


def _resolve_edges(
    idx: np.ndarray, w: np.ndarray, in_size: int, edge_mode: EdgeMode
) -> Tuple[np.ndarray, np.ndarray]:
    if edge_mode == EdgeMode.DROP:
        valid = (idx >= 0) & (idx < in_size)
        w = np.where(valid, w, 0.0)
        idx = np.clip(idx, 0, in_size - 1)
    elif edge_mode == EdgeMode.CLAMP:
        idx = np.clip(idx, 0, in_size - 1)
    elif edge_mode == EdgeMode.REFLECT:
        # reflect about edge samples: ... 2 1 0 1 2 ... (period 2(in-1))
        if in_size == 1:
            idx = np.zeros_like(idx)
        else:
            period = 2 * (in_size - 1)
            idx = np.abs(idx) % period
            idx = np.where(idx >= in_size, period - idx, idx)
    else:
        raise ValueError(f"unknown edge mode {edge_mode}")
    return idx.astype(np.int32), w


def banded_weights(
    in_size: int,
    out_size: int,
    a: int,
    filter_name: str = "lanczos",
    edge_mode: EdgeMode = EdgeMode.CLAMP,
    normalize: bool = True,
    antialias: bool = True,
    coord_mode: str = "exact",
    align: str = "zero",
) -> BandedOperator:
    """Build the banded operator for one axis.

    Output position ``y`` maps to input coordinate ``x = y·D/N``
    (``align="zero"``, the reference's sample-0-aligned convention,
    ``full_TB.h:57``) or ``x = (y+½)·D/N − ½`` (``align="center"``, the
    half-pixel convention of PIL/OpenCV/FSR); taps at integers
    ``i ∈ [⌊x⌋−a+1, ⌊x⌋+a]``, weight ``L(x − i)``.

    ``coord_mode``:
    - ``"exact"``: ⌊x⌋ computed in exact integer arithmetic (default).
    - ``"c_double"``: ⌊x⌋ and t computed through the same IEEE double
      divisions the reference C oracle performs (``x = xx / (N/D)``,
      ``full_TB.h:57``) — required for bit-parity with it, since the double
      quotient can floor differently at integral points.  zero-align only.

    For downscaling (N < D) with ``antialias=True`` the kernel is stretched
    by D/N (support a·D/N) — the standard high-quality convention; the
    reference only upscales so this path is an extension.
    """
    filt = get_filter(filter_name)
    n, d = reduced_scale(in_size, out_size)
    downscale = n < d and antialias
    # kernel stretch factor (as an exact rational d/n for downscale)
    if downscale:
        support = int(np.ceil(a * d / n))
    else:
        support = a
    off = 0 if align == "zero" else d - n  # x = (2yd + off) / (2n)
    y = np.arange(out_size, dtype=np.int64)
    if coord_mode == "c_double":
        if downscale:
            raise ValueError("c_double coord mode is upscale-only")
        if align != "zero":
            raise ValueError("c_double coord mode is zero-align only")
        x = y.astype(np.float64) / (float(n) / float(d))  # full_TB.h:57
        fl = np.floor(x).astype(np.int64)
    elif coord_mode == "exact":
        x = None
        fl = (2 * y * d + off) // (2 * n)
    else:
        raise ValueError(f"unknown coord_mode {coord_mode!r}")
    base = (fl - support + 1).astype(np.int64)
    j = np.arange(2 * support, dtype=np.int64)
    idx = base[:, None] + j[None, :]
    if coord_mode == "c_double":
        t = x[:, None] - idx.astype(np.float64)
    else:
        # t = x − i = (2yd + off − 2in) / 2n, exact integer numerator
        t_num = 2 * y[:, None] * d + off - 2 * idx * n
        if downscale:
            # stretched kernel: L(t·n/d), support a·d/n
            t = t_num.astype(np.float64) / (2 * d)
        else:
            t = t_num.astype(np.float64) / (2 * n)
    w = filt(t, a)
    idx32, w = _resolve_edges(idx, w, in_size, edge_mode)
    if normalize:
        s = w.sum(axis=1, keepdims=True)
        s = np.where(np.abs(s) < 1e-12, 1.0, s)
        w = w / s
    return BandedOperator(
        in_size=in_size,
        out_size=out_size,
        a=support,
        idx=idx32,
        weights=w,
        base=base.astype(np.int32),
    )


def phase_table(
    n: int,
    d: int,
    a: int,
    support: int,
    filter_name: str = "lanczos",
    normalize: bool = True,
    align: str = "zero",
) -> np.ndarray:
    """(N, 2·support) float64 per-phase tap weights — the canonical
    builder behind every fast path (kernel.cpp:50-59's phase-LUT,
    generalized to both grid alignments and stretched downscale kernels).

    Phase ``p`` has coordinate ``x = (2pd + off) / (2n)`` (off = 0 for
    zero-align, d−n for center-align); tap ``j`` sits at
    ``⌊x⌋ − support + 1 + j``; for ``support > a`` the kernel is stretched
    by d/n (antialiased downscale).
    """
    filt = get_filter(filter_name)
    off = 0 if align == "zero" else d - n
    tbl = np.zeros((n, 2 * support), dtype=np.float64)
    for p in range(n):
        fl = (2 * p * d + off) // (2 * n)
        for j in range(2 * support):
            i_orig = fl - support + 1 + j
            t = (2 * p * d + off - 2 * i_orig * n) / (2 * n)
            if support > a:
                tbl[p, j] = float(filt(np.array([t * n / d]), a)[0])
            else:
                tbl[p, j] = float(filt(np.array([t]), a)[0])
        if normalize:
            sm = tbl[p].sum()
            if abs(sm) > 1e-12:
                tbl[p] /= sm
    return tbl


@dataclasses.dataclass(frozen=True)
class PhaseWeights:
    """Phase-compressed interior weights: ``out[kN+p] = Σ_j w[p,j]·in[kD+off[p]+j]``.

    Valid wherever the whole window is in range; the banded form handles
    edge rows.  ``table`` is (N, 2a); ``off`` is (N,).
    """

    n: int
    d: int
    a: int
    table: np.ndarray  # (N, 2a) float64
    off: np.ndarray  # (N,) int32

    @classmethod
    def build(
        cls,
        in_size: int,
        out_size: int,
        a: int,
        filter_name: str = "lanczos",
        normalize: bool = True,
        align: str = "zero",
    ) -> "PhaseWeights":
        n, d = reduced_scale(in_size, out_size)
        w = phase_table(n, d, a, a, filter_name, normalize, align)
        p = np.arange(n, dtype=np.int64)
        aoff = 0 if align == "zero" else d - n
        fl = (2 * p * d + aoff) // (2 * n)
        off = fl - a + 1
        return cls(n=n, d=d, a=a, table=w, off=off.astype(np.int32))


# ---------------------------------------------------------------------------
# HLS-faithful machinery
# ---------------------------------------------------------------------------


def hls_lut(a: int, n: int, bit_precision: int, mode: str = "fp64") -> np.ndarray:
    """Fixed-point Lanczos ROM, int32 values in units of 2^-P.

    Reconstructs ``init_lanczos_kernel`` (``kernel.cpp:40-45``): LUT[i] =
    L(i/N) for i in [0, a·N), LUT[a·N] = 0, quantized to ``kernel_t =
    ap_fixed<8+P,8>`` (truncation toward −∞, the ap_fixed AP_TRN default).

    ``mode="fp64"`` evaluates L in float64 at the exact rational i/N then
    quantizes once.  ``mode="hls"`` additionally quantizes the argument to
    the kernel_t grid first (the reference computes ``(kernel_t)i/SCALE_N``
    in fixed point).  hls::sinpi's internal precision is not reproducible
    without the Vivado libraries; float64 evaluation of sin is used — the
    difference is below one LUT quantum in practice.
    """
    P = bit_precision
    scale = 1 << P
    i = np.arange(a * n + 1, dtype=np.float64)
    if mode == "hls":
        x = np.floor(i / n * scale) / scale  # (kernel_t)i / SCALE_N, AP_TRN
    elif mode == "fp64":
        x = i / n
    else:
        raise ValueError(f"unknown hls_lut mode {mode!r}")
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(
            x == 0.0,
            1.0,
            (a / np.pi**2) * np.sin(np.pi * x) * np.sin(np.pi * x / a) / (x * x),
        )
    q = np.floor(w * scale).astype(np.int32)
    q[a * n] = 0
    return q


@dataclasses.dataclass(frozen=True)
class HLSSchedule:
    """Flattened streaming schedule of one HLS worker axis.

    For each output position ``y`` (of ``out_size``), the 2a-tap window the
    reference's cyclic buffer / shift registers would hold:

    - ``eff_idx[y, j]``: source index in [0, in_size) after the zero-pre-roll
      (top/left) and saturate/replicate (bottom/right) edge behavior.
    - ``valid[y, j]``: False where the window slot holds a pre-roll zero.
    - ``lut_idx[y, j]``: index into the fixed-point ROM, as the hardware
      computes it from its *nominal* counter (``|y·D − (in_idx−2a+j)·N|``,
      ``kernel.cpp:56`` via ``lanczos.cpp:29,47``), clipped to the ROM size.
    - ``lut_overflow``: True if any nominal index exceeded the ROM (the
      quantized step predicate drifting off the ideal pattern — a latent
      reference bug for scales whose 1/scale is inexact in P fractional
      bits; the ROM read would be out of bounds in the reference).
    """

    in_size: int
    out_size: int
    a: int
    eff_idx: np.ndarray  # (out, 2a) int32
    valid: np.ndarray  # (out, 2a) bool
    lut_idx: np.ndarray  # (out, 2a) int32
    lut_overflow: bool


def hls_schedule(
    in_size: int, out_size: int, a: int, bit_precision: int
) -> HLSSchedule:
    """Simulate the worker counters once on the host, O(out_size).

    Reproduces, exactly and in one place:
    - ``initialize``: N_ZEROS = a−1 pre-roll zeros then rows 0..a
      (``worker.cpp:170-198`` with offset=0, ``worker.cpp:249-275``).
    - the quantized step predicate ``frac(q·(y+1)) < q`` with
      ``q = ⌊2^P·D/N⌋`` (``worker.cpp:140,234``; fractional_t is
      ap_ufixed<P,0> and num_el_t(1/SCALE) truncates, so the comparison is
      pure integer arithmetic mod 2^P).
    - saturate-push / shift-down replication of the newest element at the
      bottom/right edge (``cyclic_buffer.h:30-42``, ``worker.cpp:244``).
    """
    n, d = reduced_scale(in_size, out_size)
    if n < d:
        # q >= 2^P degenerates the step predicate (always true): the
        # window would advance one row per output and silently return
        # top-of-image garbage; the reference HLS design is upscale-only
        raise ValueError("the HLS stream schedule is upscale-only")
    P = bit_precision
    mask = (1 << P) - 1
    q = (d << P) // n  # num_el_t(1/SCALE) with AP_TRN truncation
    taps = 2 * a

    # window after initialize: a−1 zeros (sentinel −1) then rows 0..a
    win = [-1] * (a - 1) + list(range(min(a + 1, in_size)))
    # (if the image is shorter than a+1 rows the stream would underflow in
    # the reference; clamp the pre-roll reads to what exists + replicate)
    while len(win) < taps:
        win.append(win[-1] if win and win[-1] >= 0 else -1)
    in_idx = min(a + 1, in_size)

    eff = np.empty((out_size, taps), dtype=np.int32)
    valid = np.empty((out_size, taps), dtype=bool)
    lut = np.empty((out_size, taps), dtype=np.int64)
    for y in range(out_size):
        # kernel_vals computed from the nominal counter before exec
        b = in_idx - taps
        lut[y] = np.abs(y * d - (b + np.arange(taps)) * n)
        w = np.array(win)
        valid[y] = w >= 0
        eff[y] = np.maximum(w, 0)
        # step predicate for the *next* output position
        if ((q * (y + 1)) & mask) < q:
            if in_idx < in_size:
                win = win[1:] + [in_idx]
            else:
                win = win[1:] + [win[-1]]  # saturate: replicate newest
            in_idx += 1

    rom_max = a * n
    overflow = bool((lut > rom_max).any())
    lut_idx = np.clip(lut, 0, rom_max).astype(np.int32)
    return HLSSchedule(
        in_size=in_size,
        out_size=out_size,
        a=a,
        eff_idx=eff,
        valid=valid,
        lut_idx=lut_idx,
        lut_overflow=overflow,
    )


def fixed_point_weights(
    op: BandedOperator, bit_precision: int
) -> np.ndarray:
    """Quantize a banded operator's weights to int32 units of 2^-P (AP_TRN)."""
    scale = 1 << bit_precision
    return np.floor(op.weights * scale).astype(np.int32)
