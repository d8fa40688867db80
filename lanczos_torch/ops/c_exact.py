"""Bit-exact device emulation of the reference's fp64 oracle (c_faithful):
the port of ``lanczos_tpu/ops/c_exact.py``.

The reference software path (``full_TB.h:29-96``) computes each output
pixel as a *sequential IEEE-double* tap sum, then truncates to uint8.  Two
traits make this impossible to reproduce in fp32:

1. **Integer-phase rows** (output positions whose source coordinate is an
   integer): the mathematically-zero side taps are not zero in double —
   ``sin(M_PI*n)`` is ~1e-16 because ``M_PI`` is inexact.  For a=3 they
   carry both signs, the double sum lands a few *ulp* below the central
   pixel's value on ~2% of pixels, and the truncation yields ``p-1``.
2. **Fractional-phase rows**: fp32 accumulation can straddle a truncation
   boundary the double sum doesn't.

This module reproduces the double semantics with int64 tensor arithmetic,
which a GPU executes exactly:

- Fractional rows: a fixed-point lattice.  Weights are pre-rounded to
  ``2^-50`` units; the tap sum is an exact int64 dot product, and
  ``trunc(clip(...))`` is a shift.
- Integer-phase rows: residual weights are pre-scaled by ``2^70`` and each
  post-center accumulation step is rounded to the IEEE grid around the
  central value ``p`` (spacing ``ulp(p) = 2^(k-52)`` above, half that below
  when ``p`` is a power of two, ties-to-even).  The final truncation is
  then ``p - 1`` iff the walk ends below ``p`` (``p`` if it is 0).

Three integer semantics carry the emulation, and torch has each: ``//`` on
int64 tensors floors (negative lattice values round down, as ``jnp``'s);
``>>`` is arithmetic; and the grid spacing ``1 << (k + 18)`` is an int64
tensor shift.  No 64-bit mode needs enabling: int64 is native.  A CUDA
tensor and a CPU tensor give the same bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lanczos_torch.core.config import ResampleConfig
from lanczos_torch.ref.oracle import _oracle_weights

_LATTICE = 50  # fractional-row fixed-point bits
_WALK = 70  # integer-phase residual fixed-point bits


class _AxisTables(NamedTuple):
    idx: np.ndarray  # (out, 2a) int32, clipped tap indices (static)
    w50: np.ndarray  # (out, 2a) int64, round(w * 2^50)
    w70: np.ndarray  # (out, 2a) int64, walk rows' non-center residuals * 2^70
    is_walk: np.ndarray  # (out,) bool
    center: np.ndarray  # (out,) int64, central tap position
    fix_lo: np.ndarray  # (out,) highest in-range tap index (for in-place quirk)


def _build_axis(in_size: int, out_size: int, a: int) -> _AxisTables:
    idx, w = _oracle_weights(out_size, in_size, a)
    taps = w.shape[1]
    absw = np.abs(w)
    center = absw.argmax(1)
    cw = np.take_along_axis(w, center[:, None], 1)[:, 0]
    noncenter = np.arange(taps)[None, :] != center[:, None]
    # walk regime: exact 1.0 center + all residuals below the lattice floor
    is_walk = (cw == 1.0) & ((absw < 2.0**-40) | ~noncenter).all(1)
    w50 = np.round(w * 2.0**_LATTICE).astype(np.int64)
    w70 = np.round(
        np.where(is_walk[:, None] & noncenter, w * 2.0**_WALK, 0.0)
    ).astype(np.int64)
    hi = np.minimum(in_size - 1, idx.max(1))
    return _AxisTables(
        idx.astype(np.int32), w50, w70, is_walk, center.astype(np.int64), hi
    )


def _device_tables(tbl: _AxisTables, device) -> _AxisTables:
    """The axis' tables as tensors on ``device``: int64 (``is_walk`` bool)."""
    return _AxisTables(*(
        torch.from_numpy(np.asarray(v).astype(bool if k == "is_walk" else np.int64))
        .to(device)
        for k, v in zip(_AxisTables._fields, tbl)
    ))


def _rnd_to_grid(v, u, d):
    """Round int64 lattice value v to the IEEE grid around p: multiples of u
    (spacing above p) for v >= 0, of d (spacing below) for v < 0, ties to
    the even multiple."""
    g = torch.where(v >= 0, u, d)
    n = v // g  # floor division on int64 tensors
    r = v - n * g
    half = g >> 1
    up = (r > half) | ((r == half) & ((n & 1) == 1))
    return (n + up.to(v.dtype)) * g


def _grid_spacings(p):
    """(u, d) lattice spacings of the IEEE double grid around integer p>=1,
    in 2^-_WALK units: u = ulp(p) = 2^(k-52), d = u/2 iff p == 2^k."""
    k = torch.zeros_like(p)
    for v in (2, 4, 8, 16, 32, 64, 128):
        k = k + (p >= v).to(p.dtype)
    u = torch.ones_like(p) << (k + (_WALK - 52))
    d = torch.where((p & (p - 1)) == 0, u >> 1, u)
    return u, d


def _combine(srcs, tbl: _AxisTables, ex):
    """Shared tap-combine: ``srcs[j]`` is the int64 source of tap j (already
    broadcast against trailing dims); ``ex`` lifts a per-row (out,) table
    column to the source's shape.  ``tbl`` holds tensors."""
    taps = len(srcs)
    acc50 = None
    for j in range(taps):
        t = ex(tbl.w50[:, j]) * srcs[j]
        acc50 = t if acc50 is None else acc50 + t
    frac = torch.clamp(torch.clamp(acc50, min=0) >> _LATTICE, max=255)
    del acc50

    # integer-phase walk
    center = ex(tbl.center)
    p = torch.zeros_like(srcs[0])
    for j in range(taps):
        p = torch.where(center == j, srcs[j], p)
    u, d = _grid_spacings(p)
    pre = None
    for j in range(taps):
        t = torch.where(center > j, ex(tbl.w70[:, j]) * srcs[j], 0)
        pre = t if pre is None else pre + t
    acc = _rnd_to_grid(pre, u, d)
    del pre
    for j in range(taps):
        step = _rnd_to_grid(acc + ex(tbl.w70[:, j]) * srcs[j], u, d)
        acc = torch.where(center < j, step, acc)
    walk = torch.where(p == 0, 0, p - (acc < 0).to(p.dtype))

    return torch.where(ex(tbl.is_walk), walk, frac)


# The passes run over bands of their output index: a band's int64
# temporaries (the 2a gathered sources and _combine's lattice sum, walk and
# grid values, about _BAND_LIVE tensors of the band's size alive at once)
# stay under BAND_BYTES, so the peak no longer grows with the frame.
BAND_BYTES = 1 << 30
_BAND_LIVE = 20


def _band_rows(trailing: int) -> int:
    """Output rows of one band of a pass whose rows hold ``trailing``
    values each."""
    return max(1, BAND_BYTES // (_BAND_LIVE * 8 * max(1, trailing)))


def _exact_pass_axis0(x, tbl: _AxisTables):
    """Vectorized exact pass along axis 0, banded over the output index.
    x: (in, ...) integer tensor; ``tbl`` holds tensors on x's device.  Each
    output row depends only on ``x``, so the bands' bytes are the unbanded
    pass's."""
    tail = (1,) * (x.dim() - 1)
    out_n = tbl.idx.shape[0]
    step = _band_rows(x[0].numel())
    out = torch.empty((out_n,) + tuple(x.shape[1:]), dtype=torch.uint8, device=x.device)
    for lo in range(0, out_n, step):
        band = _AxisTables(*(v[lo : lo + step] for v in tbl))
        srcs = [x.index_select(0, band.idx[:, j]).to(torch.int64)
                for j in range(band.idx.shape[1])]
        out[lo : lo + step] = _combine(
            srcs, band, lambda col: col.reshape((-1,) + tail)).to(torch.uint8)
        del srcs
    return out


def _exact_single_row(y: int, srcs, tbl: _AxisTables):
    """Exact combine for one output row y given its 2a gathered sources."""
    row = _AxisTables(*(v[y : y + 1] for v in tbl))
    srcs = [s.to(torch.int64) for s in srcs]
    # per-row tables are 0-d after [0]; broadcasting handles the rest
    return _combine(srcs, row, lambda col: col[0]).to(torch.uint8)


class CExactOps:
    """Tables of one c_faithful config, on one device.

    The 2D schedule mirrors ``lanczos_expected`` exactly: width pass into a
    zero-initialized (out_h, out_w) uint8 buffer, then the height pass *in
    place, bottom-up* (``full_TB.h:67-77``) — rows whose tap window reaches
    above themselves read already-final rows; they are recomputed
    sequentially (descending) after the vectorized interior pass.

    ``tbl_h``/``tbl_v`` are the host tables, ``dev_h``/``dev_v`` the same
    as tensors on ``device``.
    """

    def __init__(self, cfg: ResampleConfig, device="cpu"):
        if not cfg.c_faithful:
            raise ValueError("CExactOps requires a c_faithful config")
        (in_h, in_w), (out_h, out_w) = cfg.in_shape, cfg.out_shape
        self._load(cfg, _build_axis(in_w, out_w, cfg.a), _build_axis(in_h, out_h, cfg.a),
                   device)

    @classmethod
    def from_reference(cls, cfg: ResampleConfig, tbl_h, tbl_v, device="cpu") -> "CExactOps":
        """The ops from a JAX ``CExactOps``' ``tbl_h`` and ``tbl_v`` (its
        ``_AxisTables``, fields as numpy), so the port runs on exactly its
        numbers."""
        if not cfg.c_faithful:
            raise ValueError("CExactOps requires a c_faithful config")
        ops = cls.__new__(cls)
        ops._load(cfg, _AxisTables(*map(np.asarray, tbl_h)),
                  _AxisTables(*map(np.asarray, tbl_v)), device)
        return ops

    def _load(self, cfg, tbl_h: _AxisTables, tbl_v: _AxisTables, device) -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        self.tbl_h, self.tbl_v = tbl_h, tbl_v
        self.dev_h = _device_tables(tbl_h, self.device)
        self.dev_v = _device_tables(tbl_v, self.device)
        out_h = cfg.out_shape[0]
        self.fix_rows = [
            int(y) for y in np.nonzero(tbl_v.fix_lo > np.arange(out_h))[0][::-1]
        ]

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return _c_exact_2d(img, self)


def _c_exact_2d(img: torch.Tensor, ops: CExactOps) -> torch.Tensor:
    """(..., H, W, C) uint8 → (..., OH, OW, C) uint8, the oracle's bytes."""
    if img.device != ops.device:
        raise ValueError(f"input on {img.device}, tables on {ops.device}")
    in_h = ops.cfg.in_shape[0]
    lead = tuple(img.shape[:-3])  # honor the (..., H, W, C) contract
    x = img.reshape((-1,) + tuple(img.shape[-3:]))

    # width pass (axis 2 -> axis 0): (B, in_h, out_w, C) uint8
    mid = _exact_pass_axis0(x.movedim(2, 0), ops.dev_h).movedim(0, 2)

    # height pass over the oracle's in-place buffer, whose rows below in_h
    # start as zeros: every tap index is < in_h, so only the width pass's
    # rows are read, and the quirk rows below read final rows instead
    midT = mid.movedim(1, 0)  # (in_h, B, out_w, C)
    F = _exact_pass_axis0(midT, ops.dev_v)  # (out_h, B, out_w, C)

    # in-place quirk rows, descending: taps above y read final rows
    idx_v = ops.tbl_v.idx
    for y in ops.fix_rows:
        srcs = [(F[int(i)] if int(i) > y else midT[int(i)]) for i in idx_v[y]]
        F[y] = _exact_single_row(y, srcs, ops.dev_v)

    out = F.movedim(0, 1)
    return out.reshape(lead + tuple(out.shape[1:]))
