"""Phase-uniform banded resampling on the H100 (v1): the per-axis phase
plan, the kernel's wrapper and its plain PyTorch version.

The port of ``lanczos_tpu/ops/resample_pallas.py``'s v1 variant
(``_plan_axis``, ``_phase_band_matrix``'s tap placement,
``PallasOps.pad_input``, ``_fused_kernel``, ``_fused_call``): the kernel
``PallasOps`` runs where no fused plan fits and some axis is not an
integer upscale (D = 1, N ≤ 16).  Per axis, with N/D the reduced scale and
``xp`` the input padded by that axis's support ``s`` (``a`` for upscales,
``⌈a·D/N⌉`` for downscales, so the two axes may differ),

    mid[r][x] = Σ_t tbl_v[r%N_v][t] · xp[(r//N_v)·D_v + fl_v[r%N_v] + 1 + t][x]
    out[r][c] = Σ_t tbl_h[c%N_h][t] · mid[r][(c//N_h)·D_h + fl_h[c%N_h] + 1 + t]

where ``fl(p) = (2·p·D + off)//(2·N)`` (floor division; ``off`` is 0, or
``D − N`` with ``align="center"``): kernel 2's formula with D in place of
1.  Each sum is taken in tap order, a multiply and then an add, and the
output is trunc-clipped uint8.

Precision follows the JAX v1: an integer axis (D = 1, N ≤ 16) keeps fp32
weights in both modes; in bf16 a rational axis's weights are rounded to
bf16 keeping each phase's tap sum (``resample_cuda._round_bf16``), and
where the horizontal axis is rational the intermediate is rounded to bf16
before that pass.  The TPU summed a rational axis as dense per-tile hi/lo
bf16 products; the port sums the same taps band-sparse, so only the order
of those sums differs from it.

The pad is never materialized: per-axis maps send each padded coordinate
to its source pixel (``np.pad``'s ``edge`` and ``reflect``, including a
support larger than the image) or to none (``constant``, zero).  On a CUDA
tensor :func:`phase_call` launches ``csrc/phase_resample.cu``; on a CPU
tensor it runs :func:`phase_resample_reference`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lanczos_torch.core.config import Precision, ResampleConfig, reduced_scale
from lanczos_torch.core.weights import phase_table
from lanczos_torch.ops import _build
from lanczos_torch.ops.resample_shift_cuda import (
    _PAD_MODE, GATHER, MAX_PHASES, _floors, _pad_map, _shift_pass,
    refuse_without_plan,
)

# Launches of the v1 kernel by this process, per instantiation; only
# phase_call adds to it, where it launches.
launches = {"phase_resample_fp32": 0, "phase_resample_bf16": 0}

# Output tiles (rows, columns) of one block, largest first; the first whose
# band and intermediate fit shared memory is used.
TILES = ((32, 128), (16, 64), (16, 32), (8, 32), (8, 16), (4, 8), (1, 1))


@dataclasses.dataclass(frozen=True, eq=False)
class PhaseAxis:
    """One axis of a v1 resample: the reduced scale ``n/d``, the support
    ``s`` per side, the alignment offset ``off``, the per-phase floors
    ``fl(p)`` (int32), the ``(n, 2·s)`` float32 phase table, whether the
    axis is an integer upscale (``PallasOps``' ``v_shift``/``h_shift``),
    and ``pad``, the source pixel of each of the ``size + 2·s`` padded
    coordinates (−1 for a zero)."""

    n: int
    d: int
    support: int
    off: int
    floors: np.ndarray
    tbl: np.ndarray
    integer: bool
    pad: np.ndarray

    def taps(self, out_size: int) -> tuple:
        """``(base, phase)`` int64 arrays: output ``o`` reads padded
        coordinates ``base[o] + t`` (t < 2·s) with weights ``tbl[phase[o]]``."""
        o = np.arange(out_size, dtype=np.int64)
        ph = o % self.n
        return (o // self.n) * self.d + self.floors[ph].astype(np.int64) + 1, ph

    def table(self, precision: Precision) -> np.ndarray:
        """The weights the kernel uses: in bf16, a rational axis's rounded
        keeping each phase's tap sum; otherwise the fp32 table."""
        from lanczos_torch.ops.resample_cuda import _round_bf16  # it imports this module

        if Precision(precision) == Precision.BF16 and not self.integer:
            return _round_bf16(self.tbl, 1)
        return self.tbl


@dataclasses.dataclass(frozen=True, eq=False)
class PhasePlan:
    """The vertical (``v``) and horizontal (``h``) axes of a v1 resample."""

    v: PhaseAxis
    h: PhaseAxis

    def rounds_mid(self, precision: Precision) -> bool:
        """Whether the intermediate is rounded to bf16 (bf16 with a rational
        horizontal axis, as the JAX v1's ``dot(tmp.astype(bf16), wh)``)."""
        return Precision(precision) == Precision.BF16 and not self.h.integer


def _is_integer(n: int, d: int) -> bool:
    return d == 1 and n <= MAX_PHASES


def _axis(in_size: int, out_size: int, cfg: ResampleConfig) -> PhaseAxis:
    n, d = reduced_scale(in_size, out_size)
    s = cfg.a if n >= d else -(-(cfg.a * d) // n)
    off = 0 if cfg.align.value == "zero" else d - n
    tbl = phase_table(n, d, cfg.a, s, cfg.filter, cfg.normalize, cfg.align.value)
    return PhaseAxis(
        n=n, d=d, support=s, off=off, floors=_floors(n, d, off),
        tbl=tbl.astype(np.float32), integer=_is_integer(n, d),
        pad=_pad_map(in_size, s, _PAD_MODE[cfg.edge_mode]),
    )


def phase_plan(cfg: ResampleConfig) -> PhasePlan:
    """The v1 plan of a config (``PallasOps``' ``pv``/``ph``, ``tbl_v``/
    ``tbl_h``, ``off_v``/``off_h`` and ``pad_input``, without Mosaic's tile,
    lane and chunk alignment)."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    return PhasePlan(v=_axis(ih, oh, cfg), h=_axis(iw, ow, cfg))


def phase_plan_from_reference(ops) -> PhasePlan:
    """The port's v1 plan from a JAX ``PallasOps``: its ``tbl_v``,
    ``tbl_h``, ``pv``/``ph`` (``n``, ``d``, ``support``), ``off_v``,
    ``off_h``, ``v_shift``/``h_shift``, ``pad_mode`` and ``cfg.in_shape``,
    so the port runs on exactly the numbers the TPU kernel used."""
    (ih, iw) = ops.cfg.in_shape

    def axis(p, tbl, off, integer, size):
        return PhaseAxis(
            n=p.n, d=p.d, support=p.support, off=int(off),
            floors=_floors(p.n, p.d, int(off)), tbl=np.asarray(tbl, np.float32),
            integer=bool(integer), pad=_pad_map(size, p.support, ops.pad_mode),
        )

    return PhasePlan(
        v=axis(ops.pv, ops.tbl_v, ops.off_v, ops.v_shift, ih),
        h=axis(ops.ph, ops.tbl_h, ops.off_h, ops.h_shift, iw),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def phase_resample_reference(
    x: torch.Tensor, plan: PhasePlan, precision: Precision | str, out_shape: tuple
) -> torch.Tensor:
    """Plain PyTorch version of the v1 kernel: (NC, H, W) uint8 → (NC, OH,
    OW) uint8.  The vertical pass over every padded column, the bf16
    rounding of the intermediate where :meth:`PhasePlan.rounds_mid`, the
    horizontal pass, ``trunc(clip(·, 0, 255))``; each sum in tap order, a
    multiply and then an add (``resample_shift_cuda._shift_pass``)."""
    precision = Precision(precision)
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (NC, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    nc, h, w = x.shape
    v, hz = plan.v, plan.h
    if (v.pad.shape[0], hz.pad.shape[0]) != (h + 2 * v.support, w + 2 * hz.support):
        raise ValueError(f"plan's pad maps do not fit a {h}x{w} input")
    xf = torch.zeros((nc, h + 1, w + 1), dtype=torch.float32, device=x.device)
    xf[:, :h, :w] = x  # row h and column w are the pad's zeros
    rows = torch.from_numpy(np.where(v.pad < 0, h, v.pad).astype(np.int64))
    cols = torch.from_numpy(np.where(hz.pad < 0, w, hz.pad).astype(np.int64))
    xp = xf[:, rows.to(x.device)][:, :, cols.to(x.device)]
    mid = _shift_pass(xp, v.table(precision), v.floors, out_shape[0], v.support, 1,
                      False, v.d)
    del xp
    if plan.rounds_mid(precision):
        mid = mid.to(torch.bfloat16).to(torch.float32)
    y = _shift_pass(mid, hz.table(precision), hz.floors, out_shape[1], hz.support, 2,
                    False, hz.d)
    return torch.trunc(torch.clamp(y, 0.0, 255.0)).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _extent(base: np.ndarray, tile: int, taps: int) -> int:
    """Padded coordinates one tile of ``tile`` outputs reads, at most."""
    first = base[::tile]
    last = base[np.minimum(np.arange(tile - 1, len(base) + tile - 1, tile), len(base) - 1)]
    return int((last - first).max()) + taps


def smem_bytes(ev: int, eh: int, tr: int, mid_bytes: int) -> int:
    """Shared memory of one block (mirrors the launcher): the band's int32
    row and column maps and the uint8 band (``ev`` × ``eh``), each padded
    to 16 bytes, and the intermediate (``tr`` × ``eh`` values of
    ``mid_bytes``)."""
    r16 = lambda n: -(-n // 16) * 16  # noqa: E731
    return r16(4 * (ev + eh)) + r16(ev * eh) + tr * eh * mid_bytes


def kernel_tiles(plan: PhasePlan, out_shape: tuple, mid_bytes: int) -> Optional[tuple]:
    """``(tr, tc, ev, eh)``: output rows and columns of one block, and the
    padded rows and columns its band spans at most, for the first of
    :data:`TILES` that fits shared memory; None where none does.  Steep
    downscales shrink the tile: at 1/16 (support 48) a 16×32 tile reads a
    336×592 band."""
    (oh, ow) = out_shape
    base_v, _ = plan.v.taps(oh)
    base_h, _ = plan.h.taps(ow)
    for rt, ct in TILES:
        tr, tc = min(rt, oh), min(ct, ow)
        ev = _extent(base_v, tr, 2 * plan.v.support)
        eh = _extent(base_h, tc, 2 * plan.h.support)
        if smem_bytes(ev, eh, tr, mid_bytes) <= _build.SMEM_LIMIT:
            return tr, tc, ev, eh
    return None


class PhaseOps:
    """One v1 config's plan, on one device.

    Raises ``NotImplementedError`` where ``PallasOps`` raises for a config
    without an MXU plan (``resample_shift_cuda.refuse_without_plan``).
    ``kernel`` names the instantiation: ``phase_resample_bf16`` holds the
    intermediate in bf16 (a bf16 config with a rational horizontal axis);
    every other config, a bf16 one with an integer horizontal axis
    included, keeps it in fp32 (``phase_resample_fp32``).  On CUDA the
    tables, the per-output band offsets and phases and the pad maps are
    uploaded once."""

    def __init__(self, cfg: ResampleConfig, device, plan: Optional[PhasePlan] = None):
        refuse_without_plan(cfg)
        self.cfg = cfg
        self.plan = plan = phase_plan(cfg) if plan is None else plan
        self.device = torch.device(device)
        bf16_mid = plan.rounds_mid(cfg.precision)
        self.kernel = f"phase_resample_{'bf16' if bf16_mid else 'fp32'}"
        self.tensors = self.tiles = None
        if self.device.type == "cuda":
            self.tiles = kernel_tiles(plan, cfg.out_shape, 2 if bf16_mid else 4)
            if self.tiles is None:
                raise NotImplementedError(
                    f"a v1 block at supports {plan.v.support}, {plan.h.support} "
                    f"outgrows shared memory; {GATHER}"
                )
            (oh, ow) = cfg.out_shape
            (base_v, ph_v), (base_h, ph_h) = plan.v.taps(oh), plan.h.taps(ow)
            host = dict(
                tbl_v=plan.v.table(cfg.precision), tbl_h=plan.h.table(cfg.precision),
                base_v=base_v, ph_v=ph_v, base_h=base_h, ph_h=ph_h,
                rows=plan.v.pad, cols=plan.h.pad,
            )
            self.tensors = {
                k: torch.from_numpy(np.ascontiguousarray(
                    a.astype(np.float32 if k.startswith("tbl") else np.int32)
                )).to(self.device)
                for k, a in host.items()
            }
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")


def phase_call(ops: PhaseOps, x: torch.Tensor) -> torch.Tensor:
    """(NC, H, W) uint8 → (NC, OH, OW) uint8 on ``ops``'s device: a CUDA
    tensor launches the v1 kernel (or raises), a CPU tensor runs the plain
    version."""
    (h, w), (oh, ow) = ops.cfg.in_shape, ops.cfg.out_shape
    if x.dtype != torch.uint8 or x.dim() != 3 or tuple(x.shape[1:]) != (h, w):
        raise ValueError(f"expected (NC, {h}, {w}) uint8, got {tuple(x.shape)} {x.dtype}")
    if x.device != ops.device:
        raise ValueError(f"input on {x.device}, tables on {ops.device}")
    if x.device.type == "cpu":
        return phase_resample_reference(x, ops.plan, ops.cfg.precision, (oh, ow))
    if not x.is_contiguous():
        raise ValueError("the v1 kernel needs a contiguous input")
    nc, (tr, tc, ev, eh) = x.shape[0], ops.tiles
    if nc > 65535 or -(-oh // tr) > 65535:
        raise ValueError(f"{nc} planes or {-(-oh // tr)} row tiles exceed the grid")
    lib = _build.library()
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=x.device)
    t, p = ops.tensors, ops.plan
    with torch.cuda.device(x.device):
        code = lib.lanczos_phase_resample(
            x.data_ptr(), out.data_ptr(), t["tbl_v"].data_ptr(), t["tbl_h"].data_ptr(),
            t["base_v"].data_ptr(), t["ph_v"].data_ptr(), t["base_h"].data_ptr(),
            t["ph_h"].data_ptr(), t["rows"].data_ptr(), t["cols"].data_ptr(),
            nc, h, w, oh, ow, 2 * p.v.support, 2 * p.h.support, tr, tc, ev, eh,
            int(ops.kernel.endswith("bf16")),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code)
    launches[ops.kernel] += 1
    return out
