"""Integer upscales as a shift-FMA on the H100: the plan, kernel 2's
wrapper and its plain PyTorch version.

The port of ``lanczos_tpu/ops/resample_pallas.py``'s v2 variant
(``_plan_axis``, ``PallasOps.pad_input``, ``_shift_pass``,
``_fused_kernel_v2``, ``_fused_call_v2``).  For D = 1 and N ≤ 16 on both
axes, with ``xp`` the input padded by ``support`` per side,

    mid[r][x] = Σ_t tbl_v[r%N_v][t] · xp[r//N_v + fp_v[r%N_v] + 1 + t][x]
    out[r][c] = Σ_t tbl_h[c%N_h][t] · mid[r][c//N_h + fp_h[c%N_h] + 1 + t]

where ``fp(p) = (2·p + off)//(2·N)`` (floor division; ``off`` is 0, or
``1 − N`` with ``align="center"``).  Each sum is taken in tap order, each
tap rounded once (the kernel's ``fmaf``; ``ops._fma.gather_sum`` here), and
with dering it is clamped to the [min, max] of its two central taps
(t = support − 1, support).  The output is
trunc-clipped uint8 and written interleaved: the TPU kernel's
phase-planar store, and the transpose after it, were a Mosaic workaround.

The pad is never materialized: the plan's row and column maps send each
padded coordinate to its source pixel (``np.pad``'s ``edge`` and
``reflect``) or to none (``constant``, zero), and the kernel and the plain
version both read through them.

v2 ignores ``precision``: the TPU kernel's weights are fp32 scalars in both
modes, so a bf16 config computes in fp32 here too.  On a CUDA tensor
:func:`shift_call` launches the kernel (``csrc/shift_resample.cu``); on a
CPU tensor it runs :func:`shift_resample_reference`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lanczos_torch.core.config import EdgeMode, Order, ResampleConfig
from lanczos_torch.core.config import reduced_scale
from lanczos_torch.core.weights import phase_table
from lanczos_torch.ops import _build
from lanczos_torch.ops._fma import gather_sum

# Launches of kernel 2 by this process; only shift_call adds to it, where
# it launches.
launches = {"shift_resample": 0}

MAX_PHASES = 16  # PallasOps' v2 domain: D = 1 and N <= 16 on both axes
_PAD_MODE = {EdgeMode.CLAMP: "edge", EdgeMode.DROP: "constant",
             EdgeMode.REFLECT: "reflect"}
GATHER = "the gather path takes it (backend='xla'; 'auto' routes it off the kernels)"


@dataclasses.dataclass(frozen=True, eq=False)
class ShiftPlan:
    """Phase tables and padded-coordinate maps of one v2 resample.

    ``tbl_v`` ``(nv, 2·support)`` and ``tbl_h`` ``(nh, 2·support)`` are
    float32; ``fp_v``, ``fp_h`` the per-phase coordinate floors; ``rows``
    ``(H + 2·support,)`` and ``cols`` ``(W + 2·support,)`` the source pixel
    of each padded row and column, −1 for a zero."""

    nv: int
    nh: int
    support: int
    tbl_v: np.ndarray
    tbl_h: np.ndarray
    fp_v: np.ndarray
    fp_h: np.ndarray
    rows: np.ndarray
    cols: np.ndarray


def _floors(n: int, d: int, off: int) -> np.ndarray:
    """Per-phase coordinate floors ``(2·p·d + off)//(2·n)`` (Python floor
    division: ``off`` is negative for a center-aligned upscale)."""
    return np.array([(2 * p * d + off) // (2 * n) for p in range(n)], np.int32)


def _pad_map(size: int, support: int, mode: str) -> np.ndarray:
    src = np.arange(size, dtype=np.int32)
    if mode == "constant":
        return np.pad(src, support, mode="constant", constant_values=-1)
    return np.pad(src, support, mode=mode)


def shift_plan(cfg: ResampleConfig) -> ShiftPlan:
    """The v2 plan of an integer-upscale config (``PallasOps``'s
    ``tbl_v``/``tbl_h``, ``off_v``/``off_h`` and ``pad_input``)."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    nv, nh = reduced_scale(ih, oh)[0], reduced_scale(iw, ow)[0]
    s, al = cfg.a, cfg.align.value
    tbl = [
        phase_table(n, 1, cfg.a, s, cfg.filter, cfg.normalize, al).astype(np.float32)
        for n in (nv, nh)
    ]
    off = [0 if al == "zero" else 1 - n for n in (nv, nh)]
    mode = _PAD_MODE[cfg.edge_mode]
    return ShiftPlan(
        nv=nv, nh=nh, support=s, tbl_v=tbl[0], tbl_h=tbl[1],
        fp_v=_floors(nv, 1, off[0]), fp_h=_floors(nh, 1, off[1]),
        rows=_pad_map(ih, s, mode), cols=_pad_map(iw, s, mode),
    )


def shift_plan_from_reference(ops) -> ShiftPlan:
    """The port's v2 plan from a JAX ``PallasOps`` built for v2: its
    ``tbl_v``, ``tbl_h``, ``pv``/``ph`` (``n``, ``d``, ``support``),
    ``off_v``, ``off_h``, ``pad_mode`` and ``cfg.in_shape``, so the port
    runs on exactly the numbers the TPU kernel used."""
    pv, ph = ops.pv, ops.ph
    if pv.d != 1 or ph.d != 1 or pv.support != ph.support:
        raise ValueError("not a v2 plan: v2 needs D = 1 and one support on both axes")
    (ih, iw), s = ops.cfg.in_shape, pv.support
    return ShiftPlan(
        nv=pv.n, nh=ph.n, support=s,
        tbl_v=np.asarray(ops.tbl_v, np.float32), tbl_h=np.asarray(ops.tbl_h, np.float32),
        fp_v=_floors(pv.n, 1, ops.off_v), fp_h=_floors(ph.n, 1, ops.off_h),
        rows=_pad_map(ih, s, ops.pad_mode), cols=_pad_map(iw, s, ops.pad_mode),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _shift_pass(x, tbl, fp, out_size: int, s: int, axis: int, dering: bool, d: int = 1):
    """One axis of the shift-FMA over the padded ``x``, in tap order: output
    ``o`` (phase ``p = o % N``) reads ``x[(o//N)·d + fp[p] + 1 + t]``."""
    n = tbl.shape[0]
    o = np.arange(out_size)
    ph = o % n
    base = torch.from_numpy(((o // n) * d + fp[ph] + 1).astype(np.int64)).to(x.device)
    w = torch.from_numpy(np.ascontiguousarray(tbl[ph])).to(x.device)  # (out, 2s)
    acc = gather_sum(x, axis, base[:, None] + torch.arange(2 * s, device=x.device), w)
    if dering:
        c0 = x.index_select(axis, base + s - 1)
        c1 = x.index_select(axis, base + s)
        acc = torch.minimum(torch.maximum(acc, torch.minimum(c0, c1)),
                            torch.maximum(c0, c1))
    return acc


def shift_resample_reference(
    x: torch.Tensor, plan: ShiftPlan, out_shape: tuple, dering: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of kernel 2: (NC, H, W) uint8 → (NC, OH, OW)
    uint8, fp32, vertical pass then horizontal, ``trunc(clip(·, 0, 255))``."""
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (NC, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    nc, h, w = x.shape
    xf = torch.zeros((nc, h + 1, w + 1), dtype=torch.float32, device=x.device)
    xf[:, :h, :w] = x  # row h and column w are the pad's zeros
    rows = torch.from_numpy(np.where(plan.rows < 0, h, plan.rows).astype(np.int64))
    cols = torch.from_numpy(np.where(plan.cols < 0, w, plan.cols).astype(np.int64))
    xp = xf[:, rows.to(x.device)][:, :, cols.to(x.device)]
    s = plan.support
    mid = _shift_pass(xp, plan.tbl_v, plan.fp_v, out_shape[0], s, 1, dering)
    y = _shift_pass(mid, plan.tbl_h, plan.fp_h, out_shape[1], s, 2, dering)
    return torch.trunc(torch.clamp(y, 0.0, 255.0)).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


RUN = 4  # source rows (columns) of one thread's run in the kernel


def smem_bytes(plan: ShiftPlan, tr: int, tc: int) -> int:
    """Shared memory of one block of the kernel (mirrors its launcher): the
    uint8 band (``tr/nv + 2·support`` rows, its origin moved left to a
    16-byte boundary of the source and a word of slack for the realigning
    loads), the fp32 intermediate (``tr`` rows of ``tc/nh + 2·support``
    columns rounded up to 4), the staged uint8 output tile, and both phase
    tables and floors."""
    taps = 2 * plan.support
    mwid = -(-(tc // plan.nh + taps) // 4) * 4
    bwid = -(-(mwid + 19) // 16) * 16
    ev = tr // plan.nv + taps
    return ev * bwid + 4 * tr * mwid + tr * tc + 4 * (plan.nv + plan.nh) * (taps + 1)


def kernel_tiles(plan: ShiftPlan) -> tuple:
    """Output rows and columns of one block: about 64 × 128, whole phase
    periods of a multiple of 4 source rows and of 16 source columns (the
    kernel's thread runs and 16-byte stores), shrunk until a block fits
    shared memory; None where the smallest does not."""
    for rt, ct in ((64, 128), (32, 64), (16, 32), (1, 1)):
        tr = plan.nv * max(RUN, rt // plan.nv // RUN * RUN)
        tc = plan.nh * max(16, ct // plan.nh // 16 * 16)
        if smem_bytes(plan, tr, tc) <= _build.SMEM_LIMIT:
            return tr, tc
    return None


def integer_scale(cfg: ResampleConfig) -> bool:
    """v2's domain (``PallasOps.v2``): D = 1 and N <= 16 on both axes."""
    (nv, dv), (nh, dh) = cfg.scale_h, cfg.scale_w
    return dv == 1 and dh == 1 and nv <= MAX_PHASES and nh <= MAX_PHASES


def refuse_without_plan(cfg: ResampleConfig) -> None:
    """Raise ``NotImplementedError`` where ``PallasOps`` raises for a config
    without an MXU plan (v1 and v2 alike): drop edges with normalization
    or dering, the quantized intermediate, width-first or rational
    dering."""
    drop = cfg.edge_mode == EdgeMode.DROP
    if drop and cfg.normalize:
        raise NotImplementedError(
            "drop edges with normalization need a fused plan (a zero pad "
            f"cannot renormalize); {GATHER}"
        )
    if cfg.intermediate_quantize:
        raise NotImplementedError(
            f"the quantized intermediate needs a fused plan; {GATHER}"
        )
    if drop and cfg.dering:
        raise NotImplementedError(
            "drop-edge dering clamps to edge-clamped taps, which a zero pad "
            f"does not have; {GATHER}"
        )
    if cfg.dering and (cfg.order != Order.HEIGHT_FIRST or not integer_scale(cfg)):
        raise NotImplementedError(
            "dering without a fused plan needs a height-first integer "
            f"upscale (N <= {MAX_PHASES}) for v2; {GATHER}"
        )


class ShiftOps:
    """One v2 config's plan, on one device.

    Raises ``NotImplementedError`` where ``PallasOps`` raises for a config
    without an MXU plan (:func:`refuse_without_plan`), and ``ValueError``
    outside v2's integer domain, which ``resample_phase_cuda.PhaseOps``
    (v1) takes."""

    def __init__(self, cfg: ResampleConfig, device):
        refuse_without_plan(cfg)
        if not integer_scale(cfg):
            raise ValueError(
                f"v2 takes integer upscales (D = 1, N <= {MAX_PHASES}); "
                "v1 (resample_phase_cuda.PhaseOps) takes this config"
            )
        self.cfg = cfg
        self.plan = plan = shift_plan(cfg)
        self.device = torch.device(device)
        self.tensors = self.tiles = None
        if self.device.type == "cuda":
            self.tiles = kernel_tiles(plan)
            if self.tiles is None:
                raise NotImplementedError(
                    f"a v2 block at support {plan.support} outgrows shared "
                    f"memory; {GATHER}"
                )
            self.tensors = {
                k: torch.from_numpy(np.ascontiguousarray(getattr(plan, k))).to(self.device)
                for k in ("tbl_v", "tbl_h", "fp_v", "fp_h", "rows", "cols")
            }
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")


def shift_call(ops: ShiftOps, x: torch.Tensor) -> torch.Tensor:
    """(NC, H, W) uint8 → (NC, OH, OW) uint8 on ``ops``'s device: a CUDA
    tensor launches kernel 2 (or raises), a CPU tensor runs the plain
    version."""
    (h, w), (oh, ow) = ops.cfg.in_shape, ops.cfg.out_shape
    if x.dtype != torch.uint8 or x.dim() != 3 or tuple(x.shape[1:]) != (h, w):
        raise ValueError(f"expected (NC, {h}, {w}) uint8, got {tuple(x.shape)} {x.dtype}")
    if x.device != ops.device:
        raise ValueError(f"input on {x.device}, tables on {ops.device}")
    if x.device.type == "cpu":
        return shift_resample_reference(x, ops.plan, (oh, ow), ops.cfg.dering)
    if not x.is_contiguous():
        raise ValueError("kernel 2 needs a contiguous input")
    nc, (tr, tc) = x.shape[0], ops.tiles
    if nc > 65535 or -(-oh // tr) > 65535:
        raise ValueError(f"{nc} planes or {-(-oh // tr)} row tiles exceed the grid")
    lib = _build.library()
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=x.device)
    t, p = ops.tensors, ops.plan
    with torch.cuda.device(x.device):
        code = lib.lanczos_shift_resample(
            x.data_ptr(), out.data_ptr(), t["tbl_v"].data_ptr(), t["tbl_h"].data_ptr(),
            t["fp_v"].data_ptr(), t["fp_h"].data_ptr(), t["rows"].data_ptr(),
            t["cols"].data_ptr(), nc, h, w, oh, ow, p.nv, p.nh, p.support, tr, tc,
            int(ops.cfg.dering), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code)
    launches["shift_resample"] += 1
    return out
