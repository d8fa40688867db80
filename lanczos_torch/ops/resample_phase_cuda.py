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
1.  Each sum is taken in tap order, each tap rounded once (the kernels'
``fmaf``), and the output is trunc-clipped uint8.

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

The source holds three designs, and :func:`choose_design` picks one from
the plan alone: ``stream`` where the vertical axis is a steep downscale
with one phase (1/D, D ≥ 4: the 8K thumbnail) — two kernels, a vertical
pass that walks down the input rows once and a horizontal pass over its
intermediate in device memory, each with a wrapper and a plain version of
its own (:func:`stream_v_call`, :func:`stream_h_call`); ``window`` where
both axes have at most 16 phases and 8 taps (3/2, 4/3, an integer axis
beside them) — a register window per thread, as kernel 2; ``generic`` for
the rest.  ``PhaseOps(design="generic")`` forces the generic design, the
one the port had first, for tests and for timing the others beside it.
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

# Launches of the v1 kernels by this process, per kernel and intermediate
# type; each wrapper adds to its own, where it launches.
launches = {
    f"phase_{k}_{t}": 0
    for k in ("resample", "window", "stream_v", "stream_h") for t in ("fp32", "bf16")
}

DESIGNS = ("auto", "generic", "window", "stream")
# Output tiles (rows, columns) of one block of the generic design, largest
# first; the first whose band and intermediate fit shared memory is used.
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
    horizontal pass, ``trunc(clip(·, 0, 255))``; each sum in tap order, each
    tap rounded once (``resample_shift_cuda._shift_pass``)."""
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


def stream_v_reference(
    x: torch.Tensor, plan: PhasePlan, precision: Precision | str, out_rows: int
) -> torch.Tensor:
    """Plain PyTorch version of the streamed vertical pass: (NC, H, W) uint8
    → the (NC, OH, W) intermediate over the source columns, bf16 where
    :meth:`PhasePlan.rounds_mid`, else float32."""
    precision = Precision(precision)
    nc, h, w = x.shape
    v = plan.v
    xf = torch.zeros((nc, h + 1, w), dtype=torch.float32, device=x.device)
    xf[:, :h] = x  # row h is the pad's zeros
    rows = torch.from_numpy(np.where(v.pad < 0, h, v.pad).astype(np.int64))
    mid = _shift_pass(xf[:, rows.to(x.device)], v.table(precision), v.floors, out_rows,
                      v.support, 1, False, v.d)
    return mid.to(torch.bfloat16) if plan.rounds_mid(precision) else mid


def stream_h_reference(
    mid: torch.Tensor, plan: PhasePlan, precision: Precision | str, out_cols: int
) -> torch.Tensor:
    """Plain PyTorch version of the horizontal pass over the streamed
    intermediate: (NC, OH, W) float32 or bf16 → (NC, OH, OW) uint8, the
    padded columns read through the column map."""
    nc, oh, w = mid.shape
    hz = plan.h
    mf = torch.zeros((nc, oh, w + 1), dtype=torch.float32, device=mid.device)
    mf[:, :, :w] = mid  # column w is the pad's zeros
    cols = torch.from_numpy(np.where(hz.pad < 0, w, hz.pad).astype(np.int64))
    y = _shift_pass(mf[:, :, cols.to(mid.device)], hz.table(Precision(precision)), hz.floors,
                    out_cols, hz.support, 2, False, hz.d)
    return torch.trunc(torch.clamp(y, 0.0, 255.0)).to(torch.uint8)


# ---------------------------------------------------------------------------
# the designs and their host layouts (each mirrored by its launcher)
# ---------------------------------------------------------------------------

STREAM_MIN_D = 4  # a 1/D vertical axis streams from here on
STREAM_LIVE = (4, 6, 8)  # live output rows (2a) the streamed pass is built for
STREAM_STRIPE = 128  # columns of one warp of the streamed pass
STREAM_MIN_WARPS = 8  # warps an SM the streamed pass's grid has at least, where it can
SM_COUNT = 132  # an H100's; the wrapper asks the device
STREAM_H_ROWS = 32  # rows of one block of the streamed design's horizontal pass
WINDOW_MAX_PHASES = 16
WINDOW_MAX_TAPS = 8
# (N, D) of the axes and the (vertical, horizontal) pairs the window design
# has compile-time instantiations for, at support 3 and zero alignment
WINDOW_AXES = ((1, 1), (2, 1), (3, 2), (4, 3))
WINDOW_PAIRS = (
    ((3, 2), (3, 2)), ((4, 3), (4, 3)), ((1, 1), (4, 3)), ((1, 1), (3, 2)),
    ((2, 1), (3, 2)), ((4, 3), (1, 1)), ((3, 2), (1, 1)), ((3, 2), (2, 1)),
)


def _r(n: int, m: int) -> int:
    return -(-n // m) * m


def _streams(ax: PhaseAxis) -> bool:
    taps = 2 * ax.support
    return (ax.n == 1 and ax.d >= STREAM_MIN_D and taps % ax.d == 0
            and taps // ax.d in STREAM_LIVE)


def _windows(ax: PhaseAxis) -> bool:
    return ax.n <= WINDOW_MAX_PHASES and 2 * ax.support <= WINDOW_MAX_TAPS


def choose_design(plan: PhasePlan) -> str:
    """The design a plan runs on: ``stream`` where the vertical axis is 1/D
    with D ≥ 4 (whatever the horizontal axis: the second kernel takes any);
    ``window`` where both axes have at most 16 phases and 8 taps; else
    ``generic``.  The window design is one kernel, so both axes must fit
    it; a steep horizontal axis under a mild vertical one stays generic."""
    if _streams(plan.v):
        return "stream"
    if _windows(plan.v) and _windows(plan.h):
        return "window"
    return "generic"


def _extent(base: np.ndarray, tile: int, taps: int) -> int:
    """Padded coordinates one tile of ``tile`` outputs reads, at most."""
    first = base[::tile]
    last = base[np.minimum(np.arange(tile - 1, len(base) + tile - 1, tile), len(base) - 1)]
    return int((last - first).max()) + taps


def generic_smem_bytes(plan: PhasePlan, tr: int, tc: int, ev: int, eh: int,
                       mid_bytes: int) -> int:
    """Shared memory of one block of the generic design: the band's int32
    row and column maps, each output row's and column's band offset and
    table row, the staged tables (the whole table, or the tile's rows where
    it has more phases than the tile), the uint8 band (``ev`` × ``eh``) and
    the intermediate (``tr`` × ``eh`` values of ``mid_bytes``)."""
    tv, th = 2 * plan.v.support, 2 * plan.h.support
    head = 4 * (ev + eh + 2 * tr + 2 * tc + min(plan.v.n, tr) * tv + min(plan.h.n, tc) * th)
    return _r(head, 16) + _r(ev * eh, 16) + tr * eh * mid_bytes


def generic_tiles(plan: PhasePlan, out_shape: tuple, mid_bytes: int) -> Optional[dict]:
    """``tr``, ``tc`` (output rows and columns of one block), ``ev``, ``eh``
    (the padded rows and columns its band spans at most) and ``smem`` for
    the first of :data:`TILES` that fits shared memory; None where none
    does.  Steep downscales shrink the tile: at 1/16 (support 48) a 16×32
    tile reads a 336×592 band."""
    (oh, ow) = out_shape
    base_v, _ = plan.v.taps(oh)
    base_h, _ = plan.h.taps(ow)
    for rt, ct in TILES:
        tr, tc = min(rt, oh), min(ct, ow)
        ev = _extent(base_v, tr, 2 * plan.v.support)
        eh = _extent(base_h, tc, 2 * plan.h.support)
        smem = generic_smem_bytes(plan, tr, tc, ev, eh, mid_bytes)
        if smem <= _build.SMEM_LIMIT:
            return dict(tr=tr, tc=tc, ev=ev, eh=eh, smem=smem)
    return None


def _templated_axis(ax: PhaseAxis) -> bool:
    """Whether the window design's compile-time form of ``ax.n / ax.d``
    computes this axis: support 3 and the floors of zero alignment."""
    return ((ax.n, ax.d) in WINDOW_AXES and ax.support == 3
            and ax.floors.tolist() == [p * ax.d // ax.n for p in range(ax.n)])


def window_templated(plan: PhasePlan) -> bool:
    """Whether the plan takes a compile-time instantiation of the window
    design: both axes templated and the pair built."""
    pair = ((plan.v.n, plan.v.d), (plan.h.n, plan.h.d))
    return _templated_axis(plan.v) and _templated_axis(plan.h) and pair in WINDOW_PAIRS


def window_smem_bytes(plan: PhasePlan, pv: int, ph: int) -> int:
    """Shared memory of one block of the window design at ``pv`` × ``ph``
    periods: the uint8 band (its origin moved left to a 16-byte boundary
    of the source and a word of slack for the realigning loads), the fp32
    intermediate, the staged uint8 tile, both tables and both ``rel``."""
    v, h = plan.v, plan.h
    tr, tc = v.n * pv, h.n * ph
    ev = (pv - 1) * v.d + int(np.ptp(v.floors)) + 2 * v.support
    mwid = _r((ph - 1) * h.d + int(np.ptp(h.floors)) + 2 * h.support, 4)
    bwid = _r(mwid + 19, 16)
    return (ev * bwid + 4 * tr * (mwid + 4) + tr * tc
            + 4 * (v.n * 2 * v.support + h.n * 2 * h.support) + 4 * (v.n + h.n))


def window_layout(plan: PhasePlan) -> Optional[dict]:
    """``pv``, ``ph`` (phase periods of rows and of columns of one block),
    ``templ`` (a compile-time instantiation) and ``smem``: about 64 × 128
    outputs, whole runs of the kernel's threads (⌈4/D⌉ periods where the
    axis is templated), an even number of rows and a multiple of 16
    columns (the 16-byte stores), shrunk until a block fits shared memory;
    None where the smallest does not."""
    v, h = plan.v, plan.h
    templ = window_templated(plan)
    kv = -(-4 // v.d) if templ else 1
    kh = -(-4 // h.d) if templ else 1
    unit_v = next(u for u in range(kv, 2 * kv + 1, kv) if (v.n * u) % 2 == 0)
    unit_h = next(u for u in range(kh, 16 * kh + 1, kh) if (h.n * u) % 16 == 0)
    for rt, ct in ((64, 128), (32, 64), (16, 32), (1, 1)):
        pv = unit_v * max(1, rt // (v.n * unit_v))
        ph = unit_h * max(1, ct // (h.n * unit_h))
        smem = window_smem_bytes(plan, pv, ph)
        if smem <= _build.SMEM_LIMIT:
            return dict(pv=pv, ph=ph, templ=templ, smem=smem)
    return None


def stream_table(ax: PhaseAxis, precision: Precision) -> np.ndarray:
    """The streamed pass's weights, (D, 2a rounded up to 4) float32: row
    ``j`` holds, for the output rows live at the ``j``-th input row of a
    period, youngest first, the tap each receives there: the row of age
    ``k`` is at its tap ``k·D + j``."""
    live = 2 * ax.support // ax.d
    wt = np.zeros((ax.d, _r(live, 4)), np.float32)
    wt[:, :live] = ax.table(precision)[0].reshape(live, ax.d).T
    return wt


def stream_chunk_rows(out_rows: int, width: int, nc: int, live: int,
                      sms: int = SM_COUNT) -> int:
    """Output rows of one chunk of the streamed pass's grid (a warp a
    stripe of 128 columns of a chunk of a plane).  A chunk walks
    ``live − 1`` periods of input rows more than its own, so few chunks
    waste least; but the warps spread over ``sms`` SMs in whole numbers,
    and each SM wants at least :data:`STREAM_MIN_WARPS`.  Picks the chunk
    count that minimises ``⌈warps / sms⌉ · (rows + live − 1)``, the rows
    the busiest SM walks."""
    per_chunk = -(-width // STREAM_STRIPE) * nc
    best = None
    for chunks in range(1, out_rows + 1):
        rpc = -(-out_rows // chunks)
        warps = per_chunk * -(-out_rows // rpc)
        cost = -(-warps // sms) * (rpc + live - 1)
        enough = warps >= STREAM_MIN_WARPS * sms
        if best is None or (enough, -cost) > (best[0], -best[1]):
            best = (enough, cost, rpc)
        if enough and chunks >= 64:
            break
    return best[2]


def stream_v_smem_bytes(ax: PhaseAxis) -> int:
    """Shared memory of one block of the streamed pass: its warp's ring of
    three 32-row stages of 128 bytes, and the weights."""
    return 3 * 32 * STREAM_STRIPE + 4 * ax.d * _r(2 * ax.support // ax.d, 4)


def stream_h_smem_bytes(plan: PhasePlan, tc: int, eh: int) -> int:
    """Shared memory of one block of the streamed design's horizontal pass:
    the column map of its band, each output column's band offset and table
    row, the staged table, 32 rows of the fp32 band at an odd stride, and
    the staged uint8 tile."""
    taps = 2 * plan.h.support
    return (4 * (eh + 2 * tc + min(plan.h.n, tc) * taps + STREAM_H_ROWS * (eh | 1))
            + STREAM_H_ROWS * tc)


def stream_h_tiles(plan: PhasePlan, out_cols: int) -> Optional[dict]:
    """``tc`` (output columns of one block of the streamed design's
    horizontal pass, which takes 32 rows), ``eh`` (the padded columns they
    read at most) and ``smem``: the widest tile under 48 KB, so that
    several blocks share an SM; None where one column does not fit."""
    base_h, _ = plan.h.taps(out_cols)
    for ct in (32, 16, 8, 4, 2, 1):
        tc = min(ct, out_cols)
        eh = _extent(base_h, tc, 2 * plan.h.support)
        smem = stream_h_smem_bytes(plan, tc, eh)
        if smem <= (48 * 1024 if ct > 1 else _build.SMEM_LIMIT):
            return dict(tc=tc, eh=eh, smem=smem)
    return None


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


class PhaseOps:
    """One v1 config's plan, on one device.

    Raises ``NotImplementedError`` where ``PallasOps`` raises for a config
    without an MXU plan (``resample_shift_cuda.refuse_without_plan``).
    ``design`` is what :func:`choose_design` picks, or ``"generic"`` where
    the constructor was told so (tests, probes and timing: the design the
    port had first); ``layout`` that design's host layout.  ``kernel``
    names the intermediate: ``phase_resample_bf16`` holds it in bf16 (a
    bf16 config with a rational horizontal axis); every other config, a
    bf16 one with an integer horizontal axis included, keeps it in fp32
    (``phase_resample_fp32``).  ``kernels`` are the keys of
    :data:`launches` one call adds to: one kernel, or the streamed
    design's two.  On CUDA the tables, band offsets, phases and pad maps
    the design reads are uploaded once."""

    def __init__(self, cfg: ResampleConfig, device, plan: Optional[PhasePlan] = None,
                 design: str = "auto"):
        refuse_without_plan(cfg)
        if design not in DESIGNS:
            raise ValueError(f"unknown design {design!r}; one of {DESIGNS}")
        self.cfg = cfg
        self.plan = plan = phase_plan(cfg) if plan is None else plan
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        bf16_mid = plan.rounds_mid(cfg.precision)
        mid = "bf16" if bf16_mid else "fp32"
        self.kernel = f"phase_resample_{mid}"
        (oh, ow) = cfg.out_shape
        picked = choose_design(plan)
        if design not in ("auto", "generic", picked):
            raise ValueError(f"the {design} design does not take this plan ({picked} does)")
        self.design = picked if design == "auto" else design
        self.layout = None
        if self.design == "stream":
            self.layout = stream_h_tiles(plan, ow)
            self.kernels = (f"phase_stream_v_{mid}", f"phase_stream_h_{mid}")
        elif self.design == "window":
            self.layout = window_layout(plan)
            self.kernels = (f"phase_window_{mid}",)
        if self.layout is None and design == "auto":
            self.design = "generic"  # no block of the selector's design fits
        if self.design == "generic":
            self.layout = generic_tiles(plan, (oh, ow), 2 if bf16_mid else 4)
            self.kernels = (self.kernel,)
        if self.layout is None:
            raise NotImplementedError(
                f"a v1 block ({self.design}) at supports {plan.v.support}, "
                f"{plan.h.support} outgrows shared memory; {GATHER}"
            )
        self.tensors = None
        self.chunk_rows = {}  # planes -> output rows a chunk of the streamed pass
        # the launcher's scalars of the plan and layout, in its argument order
        lay = self.layout
        if self.design == "window":
            self.scalars = tuple(
                int(k) for ax, periods in ((plan.v, lay["pv"]), (plan.h, lay["ph"]))
                for k in (ax.n, ax.d, ax.support, ax.floors.min() + 1, periods,
                          np.ptp(ax.floors))) + (int(lay["templ"]),)
        elif self.design == "generic":
            self.scalars = (2 * plan.v.support, 2 * plan.h.support, lay["tr"], lay["tc"],
                            lay["ev"], lay["eh"], plan.v.n, plan.h.n)
        else:  # the second kernel's; the first's are in stream_v_call
            self.scalars = (2 * plan.h.support, lay["tc"], lay["eh"], plan.h.n)
        if self.device.type == "cuda":
            self.sms = torch.cuda.get_device_properties(self.device).multi_processor_count
            (base_v, ph_v), (base_h, ph_h) = plan.v.taps(oh), plan.h.taps(ow)
            host = dict(tbl_h=plan.h.table(cfg.precision), cols=plan.h.pad, rows=plan.v.pad)
            if self.design == "stream":
                host.update(wt=stream_table(plan.v, cfg.precision), base_h=base_h, ph_h=ph_h)
            elif self.design == "window":
                host.update(tbl_v=plan.v.table(cfg.precision),
                            rel_v=plan.v.floors - plan.v.floors.min(),
                            rel_h=plan.h.floors - plan.h.floors.min())
            else:
                host.update(tbl_v=plan.v.table(cfg.precision), base_v=base_v, ph_v=ph_v,
                            base_h=base_h, ph_h=ph_h)
            self.tensors = {
                k: torch.from_numpy(np.ascontiguousarray(
                    a.astype(np.float32 if k in ("tbl_v", "tbl_h", "wt") else np.int32)
                )).to(self.device)
                for k, a in host.items()
            }


def _check_input(ops: PhaseOps, x: torch.Tensor, shape: tuple, dtypes: tuple) -> None:
    if x.dtype not in dtypes or x.dim() != 3 or tuple(x.shape[1:]) != shape:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(
            f"expected (NC, {shape[0]}, {shape[1]}) {names}, got {tuple(x.shape)} {x.dtype}")
    if x.device != ops.device:
        raise ValueError(f"input on {x.device}, tables on {ops.device}")
    if x.device.type != "cpu" and not x.is_contiguous():
        raise ValueError("the v1 kernels need a contiguous input")
    if x.shape[0] > 65535:
        raise ValueError(f"{x.shape[0]} planes exceed the grid")


def _bf16_mid(ops: PhaseOps) -> int:
    return int(ops.kernel.endswith("bf16"))


def stream_v_call(ops: PhaseOps, x: torch.Tensor, rpc: Optional[int] = None) -> torch.Tensor:
    """The streamed vertical pass: (NC, H, W) uint8 → the (NC, OH, W)
    intermediate, bf16 where the config rounds it, else float32.  A CUDA
    tensor launches ``phase_stream_v`` (or raises), a CPU tensor runs
    :func:`stream_v_reference`.  ``rpc`` overrides the output rows of one
    chunk of the grid (:func:`stream_chunk_rows`)."""
    if ops.design != "stream":
        raise ValueError(f"this plan runs the {ops.design} design: call phase_call")
    (h, w), (oh, _) = ops.cfg.in_shape, ops.cfg.out_shape
    _check_input(ops, x, (h, w), (torch.uint8,))
    if x.device.type == "cpu":
        return stream_v_reference(x, ops.plan, ops.cfg.precision, oh)
    nc, v = x.shape[0], ops.plan.v
    if rpc is None:
        rpc = ops.chunk_rows.get(nc)
        if rpc is None:
            rpc = ops.chunk_rows[nc] = stream_chunk_rows(
                oh, w, nc, 2 * v.support // v.d, ops.sms)
    rpc = int(rpc)
    if rpc < 1 or -(-oh // rpc) > 65535:
        raise ValueError(f"{rpc} rows a chunk: {oh} rows need 1 to 65535 chunks")
    lib = _build.library()
    mid = torch.empty((nc, oh, w), device=x.device,
                      dtype=torch.bfloat16 if _bf16_mid(ops) else torch.float32)
    t = ops.tensors
    with torch.cuda.device(x.device):
        code = lib.lanczos_phase_stream_v(
            x.data_ptr(), mid.data_ptr(), t["wt"].data_ptr(), t["rows"].data_ptr(),
            nc, h, w, oh, v.d, int(v.floors[0]) + 1, 2 * v.support // v.d, rpc,
            _bf16_mid(ops), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code)
    launches[ops.kernels[0]] += 1
    return mid


def stream_h_call(ops: PhaseOps, mid: torch.Tensor) -> torch.Tensor:
    """The horizontal pass over the streamed intermediate: (NC, OH, W)
    float32 or bf16 (as the config holds it) → (NC, OH, OW) uint8.  A CUDA
    tensor launches ``phase_stream_h`` (or raises), a CPU tensor runs
    :func:`stream_h_reference`."""
    if ops.design != "stream":
        raise ValueError(f"this plan runs the {ops.design} design: call phase_call")
    (_, w), (oh, ow) = ops.cfg.in_shape, ops.cfg.out_shape
    _check_input(ops, mid, (oh, w), (torch.bfloat16 if _bf16_mid(ops) else torch.float32,))
    if mid.device.type == "cpu":
        return stream_h_reference(mid, ops.plan, ops.cfg.precision, ow)
    if -(-oh // STREAM_H_ROWS) > 65535:
        raise ValueError(f"{-(-oh // STREAM_H_ROWS)} row tiles exceed the grid")
    lib = _build.library()
    nc, t = mid.shape[0], ops.tensors
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=mid.device)
    with torch.cuda.device(mid.device):
        code = lib.lanczos_phase_stream_h(
            mid.data_ptr(), out.data_ptr(), t["tbl_h"].data_ptr(), t["base_h"].data_ptr(),
            t["ph_h"].data_ptr(), t["cols"].data_ptr(), nc, w, oh, ow,
            *ops.scalars, _bf16_mid(ops),
            torch.cuda.current_stream(mid.device).cuda_stream,
        )
    _build.check(code)
    launches[ops.kernels[1]] += 1
    return out


def phase_call(ops: PhaseOps, x: torch.Tensor) -> torch.Tensor:
    """(NC, H, W) uint8 → (NC, OH, OW) uint8 on ``ops``'s device: a CUDA
    tensor launches the kernels of ``ops.design`` (or raises), a CPU
    tensor runs the plain version."""
    (h, w), (oh, ow) = ops.cfg.in_shape, ops.cfg.out_shape
    _check_input(ops, x, (h, w), (torch.uint8,))
    if x.device.type == "cpu":
        return phase_resample_reference(x, ops.plan, ops.cfg.precision, (oh, ow))
    if ops.design == "stream":
        return stream_h_call(ops, stream_v_call(ops, x))
    lib = _build.library()
    nc, lay, t, p = x.shape[0], ops.layout, ops.tensors, ops.plan
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if ops.design == "window":
            if -(-oh // (p.v.n * lay["pv"])) > 65535:
                raise ValueError(f"{-(-oh // (p.v.n * lay['pv']))} row tiles exceed the grid")
            code = lib.lanczos_phase_window(
                x.data_ptr(), out.data_ptr(), t["tbl_v"].data_ptr(), t["tbl_h"].data_ptr(),
                t["rel_v"].data_ptr(), t["rel_h"].data_ptr(), t["rows"].data_ptr(),
                t["cols"].data_ptr(), nc, h, w, oh, ow, *ops.scalars, _bf16_mid(ops), stream,
            )
        else:
            if -(-oh // lay["tr"]) > 65535:
                raise ValueError(f"{-(-oh // lay['tr'])} row tiles exceed the grid")
            code = lib.lanczos_phase_resample(
                x.data_ptr(), out.data_ptr(), t["tbl_v"].data_ptr(), t["tbl_h"].data_ptr(),
                t["base_v"].data_ptr(), t["ph_v"].data_ptr(), t["base_h"].data_ptr(),
                t["ph_h"].data_ptr(), t["rows"].data_ptr(), t["cols"].data_ptr(),
                nc, h, w, oh, ow, *ops.scalars, _bf16_mid(ops), stream,
            )
    _build.check(code)
    launches[ops.kernels[0]] += 1
    return out
