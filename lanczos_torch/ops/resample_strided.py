"""Shift-FMA resampling over strided slices: the port of
``lanczos_tpu/ops/resample_shift_xla.py`` (the ``"shift_xla"`` backend).

For ANY reduced rational scale N/D, output position k·N+p is
Σ_t w[p,t]·x[kD + ⌊pD/N⌋ + 1 + t] over the support-padded input: every
phase is a sum of 2·support stride-D slices times scalar weights (fp32 in
an fp32 sum), in tap order, each tap rounded once (``ops._fma.fma_sum``,
as XLA's CPU backend contracts the JAX chain into FMAs), and the phases
interleave with a
stack+reshape.  Downscales get the stretched-kernel treatment (support =
⌈a·D/N⌉).  Named apart from ``resample_shift_cuda``, whose ``ShiftOps`` is
kernel 2.

bf16 stores in bf16 and sums in fp32, as the gather path's bf16 does
(``resample_gather``): phase weights rounded to bf16 keeping each phase's
tap sum, the padded input and the intermediate rounded to bf16.

The pad is built from index maps (``np.pad`` on an index range, as the
kernels' plans do): ``np.pad``'s ``reflect`` reflects again where the
support is wider than the axis, which a steep downscale of a small image
needs and ``torch.nn.functional.pad`` refuses.
"""

from __future__ import annotations

import numpy as np
import torch

from lanczos_torch.core.config import EdgeMode, Order, Precision, ResampleConfig
from lanczos_torch.core.weights import phase_table
from lanczos_torch.ops._fma import by_parts, fma_sum
from lanczos_torch.ops.resample_cuda import _clamp_between, _round_bf16
from lanczos_torch.ops.resample_gather import compute_dtype, quantize_uint8, store
from lanczos_torch.ops.resample_shift_cuda import _PAD_MODE, _pad_map

MAX_PHASES = 32  # beyond this the unrolled slice-FMA graph stops paying off


def _axis_shift_pass(x, n, d, support, tbl, axis, dering, off=0):
    """1-D shift-FMA pass along ``axis`` of support-padded x (float).

    ``off`` is the grid-alignment numerator offset: the output coordinate
    is (2·y·d + off) / (2·n) — 0 for zero-align, d−n for center-align.
    """
    size = x.shape[axis]
    m = (size - 2 * support) // d  # output positions per phase
    taps = 2 * support
    # the weights in the sums' own precision: an fp32 sum takes fp32 weights
    wdt = np.float32 if x.dtype == torch.float32 else np.float64
    rows = [[float(wdt(tbl[p, t])) for t in range(taps)] for p in range(n)]

    def pass_(part):
        src = part.double() if part.dtype == torch.float32 else part  # once, not a tap

        def sl(v, lo):
            idx = [slice(None)] * v.dim()
            idx[axis] = slice(lo, lo + (m - 1) * d + 1, d)
            return v[tuple(idx)]

        phases = []
        for p in range(n):
            fp = (2 * p * d + off) // (2 * n)
            row = rows[p]
            acc = fma_sum(lambda t: (row[t], sl(src, fp + 1 + t)), taps, part, row)
            if dering:
                acc = _clamp_between(acc, sl(part, fp + support), sl(part, fp + 1 + support))
            phases.append(acc)
        if n == 1:
            return phases[0]
        stacked = torch.stack(phases, dim=axis + 1)  # (..., m, n, ...)
        shape = list(part.shape)
        shape[axis] = m * n
        return stacked.reshape(shape)

    return by_parts(x, axis, m * n, pass_)


class StridedOps:
    """The plan of the strided path (any rational scale), on one device:
    per-axis phase tables, supports, alignment offsets and pad maps
    (``rows``, ``cols``: the source of each padded row and column, the
    axis' length for a zero)."""

    def __init__(self, cfg: ResampleConfig, dtype=torch.float32, device="cpu"):
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError("shift path covers the float modes")
        if cfg.edge_mode == EdgeMode.DROP and (cfg.normalize or cfg.dering):
            raise NotImplementedError(
                "drop-edge with normalization or dering needs the gather "
                "path (zero padding cannot reproduce either)"
            )
        if cfg.intermediate_quantize:
            raise NotImplementedError(
                "the shift path fuses both passes; a quantized intermediate "
                "needs the gather path"
            )
        if cfg.order == Order.WIDTH_FIRST and cfg.dering:
            raise NotImplementedError(
                "the shift path is height-first; width-first dering is "
                "order-sensitive — use the gather path"
            )
        (ih, iw) = cfg.in_shape
        nv, dv = cfg.scale_h
        nh, dh = cfg.scale_w
        if nv > MAX_PHASES or nh > MAX_PHASES:
            raise NotImplementedError(
                f"scale phases {nv}, {nh} exceed MAX_PHASES={MAX_PHASES}; "
                "use the gather or block backend"
            )
        if ih % dv or iw % dh:
            raise NotImplementedError(
                "input dims must be divisible by the scale D — use the "
                "gather or block backend"
            )
        sup_v = cfg.a if nv >= dv else -(-(cfg.a * dv) // nv)
        sup_h = cfg.a if nh >= dh else -(-(cfg.a * dh) // nh)
        al = cfg.align.value
        self._load(cfg, dtype, device, dict(
            nv=nv, dv=dv, nh=nh, dh=dh, sup_v=sup_v, sup_h=sup_h,
            tbl_v=phase_table(nv, dv, cfg.a, sup_v, cfg.filter, cfg.normalize, al),
            tbl_h=phase_table(nh, dh, cfg.a, sup_h, cfg.filter, cfg.normalize, al),
            off_v=0 if al == "zero" else dv - nv,
            off_h=0 if al == "zero" else dh - nh,
            pad_mode=_PAD_MODE[cfg.edge_mode],
        ))

    @classmethod
    def from_reference(cls, cfg: ResampleConfig, fields: dict, dtype=torch.float32,
                       device="cpu") -> "StridedOps":
        """The ops from a JAX ``ShiftOps``' fields (``nv``, ``dv``, ``nh``,
        ``dh``, ``sup_v``, ``sup_h``, ``tbl_v``, ``tbl_h``, ``off_v``,
        ``off_h``, ``pad_mode``), so the port runs on exactly its numbers."""
        ops = cls.__new__(cls)
        ops._load(cfg, dtype, device, fields)
        return ops

    def _load(self, cfg, dtype, device, f: dict) -> None:
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.precision == Precision.BF16 else dtype
        self.device = torch.device(device)
        for k in ("nv", "dv", "nh", "dh", "sup_v", "sup_h", "off_v", "off_h"):
            setattr(self, k, int(f[k]))
        self.compute = compute_dtype(self.dtype)
        self.tbl_v = np.asarray(f["tbl_v"], np.float64)
        self.tbl_h = np.asarray(f["tbl_h"], np.float64)
        if self.dtype == torch.bfloat16:
            self.tbl_v, self.tbl_h = _round_bf16(self.tbl_v, 1), _round_bf16(self.tbl_h, 1)
        self.pad_mode = f["pad_mode"]
        (ih, iw) = cfg.in_shape

        def pad(size, support):
            m = _pad_map(size, support, self.pad_mode)
            return torch.from_numpy(np.where(m < 0, size, m).astype(np.int64)).to(self.device)

        self.rows, self.cols = pad(ih, self.sup_v), pad(iw, self.sup_h)


def resample_2d_strided(
    img: torch.Tensor, ops: StridedOps, channel_last: bool = True
) -> torch.Tensor:
    """(..., H, W, C) (default) or planar (..., H, W) → the same layout:
    uint8 for integer input, else the ops' float dtype."""
    if img.device != ops.device:
        raise ValueError(f"input on {img.device}, tables on {ops.device}")
    cfg = ops.cfg
    channel_last = channel_last and img.dim() >= 3
    x = img.movedim(-1, -3) if channel_last else img
    was_int = not x.is_floating_point()
    x = store(x.to(ops.compute), ops.dtype)
    # the pad: index maps into x with a zero row and column appended
    h, w = x.shape[-2:]
    xz = x.new_zeros(tuple(x.shape[:-2]) + (h + 1, w + 1))
    xz[..., :h, :w] = x
    x = xz.index_select(-2, ops.rows).index_select(-1, ops.cols)
    x = _axis_shift_pass(
        x, ops.nv, ops.dv, ops.sup_v, ops.tbl_v, x.dim() - 2, cfg.dering, ops.off_v,
    )
    # width axis still carries the horizontal padding; height is done
    x = _axis_shift_pass(
        store(x, ops.dtype), ops.nh, ops.dh, ops.sup_h, ops.tbl_h, x.dim() - 1,
        cfg.dering, ops.off_h,
    )
    x = quantize_uint8(x) if was_int else x.to(ops.dtype)
    if channel_last:
        x = x.movedim(-3, -1)
    return x
