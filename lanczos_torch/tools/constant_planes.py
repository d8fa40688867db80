"""Constant planes through the port's three kernel families.

    python -m lanczos_torch.tools.constant_planes [--shape H W] [--scale N D] [--a A]
        [--device cuda|cpu] [--backends xla shift_xla block] [--families ...]

A plane of one value v, resampled with normalized weights, should come out
v everywhere; an fp32 sum that lands below v truncates to v − 1.  For
each family (the fused kernel, kernel 2 and v1, the last on its own plan
even where a config is integer) and each v in 0..255, the tool runs the
kernel on one plane (on the CPU: the plain version) and the family's
plain version on the same device, requires identical bytes and outputs
in {v − 1, v}, and counts the values with any pixel at v − 1.  Beside
that it prints the same count from the plain version's own passes on the
CPU, taken over the plane's distinct rows: a constant plane's output row
depends only on that row's vertical taps, so the horizontal pass needs
each distinct intermediate value once, not once a row (at 4K→8K a few
thousand rows instead of 256 × 4320).  The two counts must agree; at
24×20, 2/1, a = 3 the value 137 must survive on every path (the JAX
package's ``tests/test_invariants.py``).  ``--backends`` counts the same
for tensor-op backends of ``Upscaler`` (with the mean share of pixels at
v − 1), ``block`` among them: it contracts in float64 and rounds each
output once.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from lanczos_torch.core.config import Precision, ResampleConfig
from lanczos_torch.ops import resample_cuda as rc
from lanczos_torch.ops import resample_phase_cuda as rp
from lanczos_torch.ops import resample_shift_cuda as rs

FAMILIES = ("fused", "kernel 2", "v1")
VALUES = torch.arange(256, dtype=torch.float32)


def family_ops(cfg: ResampleConfig, family: str, device):
    """The ops of one family: ``FusedOps`` with a fused plan, kernel 2's
    ``ShiftOps``, or v1's ``PhaseOps`` (whatever the scale)."""
    if family == "fused":
        return rc.FusedOps(cfg, device, variant="mxu")
    if family == "kernel 2":
        if not rs.integer_scale(cfg):
            raise NotImplementedError("kernel 2 takes integer upscales (D = 1) only")
        return rc.FusedOps(cfg, device, variant="v2").shift
    if family == "v1":
        return rp.PhaseOps(cfg, device)
    raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")


def kernel_of(ops, x: torch.Tensor) -> torch.Tensor:
    """The family's wrapper on planar (NC, H, W) uint8: the kernel on a
    CUDA tensor, the plain version on a CPU one."""
    if isinstance(ops, rc.FusedOps):
        return rc.fused_call(ops, x)
    if isinstance(ops, rs.ShiftOps):
        return rs.shift_call(ops, x)
    return rp.phase_call(ops, x)


def plain_of(ops, x: torch.Tensor) -> torch.Tensor:
    """The family's plain version on ``x``, on ``x``'s device."""
    cfg = ops.cfg
    if isinstance(ops, rc.FusedOps):
        return rc.fused_resample_reference(x, ops.plan, cfg.precision, cfg.out_shape)
    if isinstance(ops, rs.ShiftOps):
        return rs.shift_resample_reference(x, ops.plan, cfg.out_shape, cfg.dering)
    return rp.phase_resample_reference(x, ops.plan, cfg.precision, cfg.out_shape)


def plane_losses(ops, device) -> list:
    """Values whose plane has a pixel at v − 1 through the kernel, each
    plane's bytes checked against the plain version's."""
    (h, w), out = ops.cfg.in_shape, ops.cfg.out_shape
    lost = []
    for v in range(256):
        x = torch.full((1, h, w), v, dtype=torch.uint8, device=device)
        y = kernel_of(ops, x)
        if not torch.equal(y, plain_of(ops, x)):
            raise AssertionError(f"v={v}: the kernel differs from its plain version")
        lo, hi = int(y.min()), int(y.max())
        if tuple(y.shape) != (1, *out) or lo < max(v - 1, 0) or hi > v:
            raise AssertionError(f"v={v}: outputs {lo}..{hi} of shape {tuple(y.shape)}")
        if lo < v:
            lost.append(v)
    return lost


def _horizontal(mid: torch.Tensor, padded: np.ndarray, run) -> list:
    """Values lost through the horizontal pass ``run`` of the intermediate
    ``mid`` (256, OH): each distinct value of it as one row, laid out on
    the pass's padded columns (``padded``: the source column of each, or
    -1 for a zero)."""
    uniq = torch.unique(mid)
    src = torch.from_numpy(np.asarray(padded, np.int64))
    rows = torch.where(src[None, :] >= 0, uniq[:, None], torch.zeros(()))
    y = torch.trunc(torch.clamp(run(rows[:, None, :]), 0.0, 255.0))[:, 0]
    owner = torch.round(uniq).long()  # an intermediate lies within ulps of its v
    lo, hi = y.min(1).values.long(), y.max(1).values.long()
    if (hi > owner).any() or (lo < owner - 1).any():
        raise AssertionError("a constant plane left [v - 1, v]")
    return sorted(set(owner[lo < owner].tolist()))


def distinct_row_losses(ops) -> list:
    """Values whose plane has a pixel at v − 1, from the family's plain
    passes on the CPU over the plane's distinct rows (linear configs)."""
    cfg = ops.cfg
    if cfg.dering or cfg.intermediate_quantize:
        raise ValueError("distinct rows hold for linear configs only")
    (h, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    prec = Precision(cfg.precision)
    if isinstance(ops, rc.FusedOps):
        plan = ops.plan
        rows, taps_v = rc._reference_vertical(plan, prec, "cpu")[:2]
        cols, taps_h = rc._reference_horizontal(plan, prec, "cpu")[:2]
        hp = max(h, int(rows.max()) + taps_v.shape[1])
        wp = max(w, int(cols.max()) + taps_h.shape[1])
        col = torch.zeros((256, hp, 1))
        col[:, :h] = VALUES[:, None, None]
        mid = rc._tap_pass(col, rows, taps_v, 1)[:, :oh, 0]
        if prec == Precision.BF16:
            mid = mid.bfloat16().float()
        padded = np.where(np.arange(wp) < w, np.arange(wp), -1)
        return _horizontal(mid, padded,
                           lambda m: rc._tap_pass(m, cols, taps_h, 2)[..., :ow])
    if isinstance(ops, rs.ShiftOps):
        p = ops.plan
        axes = ((p.rows, p.tbl_v, p.fp_v, p.support, 1), (p.cols, p.tbl_h, p.fp_h, p.support, 1))
        rounds = False
    else:
        p = ops.plan
        axes = ((p.v.pad, p.v.table(prec), p.v.floors, p.v.support, p.v.d),
                (p.h.pad, p.h.table(prec), p.h.floors, p.h.support, p.h.d))
        rounds = p.rounds_mid(prec)
    (pad_v, tbl_v, fl_v, s_v, d_v), (pad_h, tbl_h, fl_h, s_h, d_h) = axes
    src = torch.from_numpy(np.asarray(pad_v, np.int64))
    col = torch.where(src[None, :] >= 0, VALUES[:, None], torch.zeros(()))[:, :, None]
    mid = rs._shift_pass(col, tbl_v, fl_v, oh, s_v, 1, False, d_v)[:, :, 0]
    if rounds:
        mid = mid.bfloat16().float()
    return _horizontal(mid, pad_h,
                       lambda m: rs._shift_pass(m, tbl_h, fl_h, ow, s_h, 2, False, d_h))


def backend_losses(cfg: ResampleConfig, backend: str, device) -> tuple:
    """A tensor-op backend of ``Upscaler`` on one plane of each value:
    the values with a pixel at v − 1 and the mean share of such pixels."""
    from lanczos_torch.models.upscaler import Upscaler

    up = Upscaler(cfg, backend=backend, device=device)
    lost, share = [], 0.0
    for v in range(256):
        y = up(torch.full((*cfg.in_shape, 1), v, dtype=torch.uint8, device=device))
        if int(y.min()) < max(v - 1, 0) or int(y.max()) > v:
            raise AssertionError(f"{backend} v={v}: outputs {int(y.min())}..{int(y.max())}")
        below = float((y < v).float().mean())
        share += below / 256
        if below:
            lost.append(v)
    return lost, share


def reference_137(device) -> dict:
    """Each family on ``tests/test_invariants.py``'s plane: 24×20, 2/1,
    a = 3, v = 137; the share of pixels that are not 137."""
    cfg = ResampleConfig.from_profile("precise", (24, 20), scale=(2, 1), a=3)
    x = torch.full((3, 24, 20), 137, dtype=torch.uint8, device=device)
    return {f: float((kernel_of(family_ops(cfg, f, device), x) != 137).float().mean())
            for f in FAMILIES}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", type=int, nargs=2, default=(2160, 3840))
    p.add_argument("--scale", type=int, nargs=2, default=(2, 1))
    p.add_argument("--a", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backends", nargs="*", default=[],
                   help="tensor-op backends of Upscaler to count too (xla, shift_xla, block)")
    p.add_argument("--families", nargs="*", default=list(FAMILIES), choices=FAMILIES)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("constant_planes: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    shares = reference_137(device)
    print(f"24x20 2/1 a=3 v=137, share of pixels not 137: {shares}")
    cfg = ResampleConfig.from_profile("precise", tuple(args.shape), scale=tuple(args.scale),
                                      a=args.a)
    bad = any(shares.values())
    for backend in args.backends:
        lost, share = backend_losses(cfg, backend, device)
        print(f"backend {backend} {args.shape[0]}x{args.shape[1]} {args.scale[0]}/{args.scale[1]} "
              f"a={args.a}: values with a pixel at v-1: {len(lost)}, mean share of such "
              f"pixels {share:.6f}; {lost}")
    for family in args.families:
        ops = family_ops(cfg, family, device)
        lost, cpu = plane_losses(ops, device), distinct_row_losses(family_ops(cfg, family, "cpu"))
        print(f"{family} {args.shape[0]}x{args.shape[1]} {args.scale[0]}/{args.scale[1]} "
              f"a={args.a}: values with a pixel at v-1: {len(lost)} on {device.type} "
              f"(kernel = plain version), {len(cpu)} from the plain passes on the CPU; "
              f"{lost}")
        bad |= lost != cpu
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
