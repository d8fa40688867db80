"""Fused separable resampling on the H100: the plan, the kernel's wrapper,
its plain PyTorch version, and the routing between the port's kernels.

The port of ``lanczos_tpu/ops/resample_pallas.py``'s MXU variant
(``_build_mxu_plan``, ``_fused_call_mxu``, ``_fused_kernel_mxu``) and of
``PallasOps``'s choice of kernel.  Both passes are products over matrices
built on the host from :func:`banded_weights`, so edge modes,
normalization and any rational N/D live in the weights:

- vertical: output rows in tiles of ``tile_out``; tile ``i`` reads input
  rows ``[starts_v[i], starts_v[i] + kv)`` through its own ``(tile_out, kv)``
  matrix ``wv[i]``;
- horizontal: output columns in blocks of ``cb``; block ``b`` reads
  intermediate columns ``[starts_h[b], starts_h[b] + kh)`` through the
  ``(kh, cb)`` matrix ``wh[uniq_h[b]]``, deduplicated across blocks.

The plan follows the TPU plan's meaning but not its Mosaic rules (no
8-row band floors, no 128-lane padding, no VMEM budget, no hi/lo bf16
split): tiles are sized for the CUDA kernel in ``csrc/fused_resample.cu``.
Reads past the image are masked to zero by the kernel, so the input is
never padded, and so are the stores at the ragged bottom and right edges.

The plan's matrices are dense but banded: a row of ``wv`` (a column of
``wh``) has one short run of nonzeros.  On the TPU the matrix unit made
the zeros free; on the H100's SIMT cores they are most of the work, so
neither the kernel nor its plain version multiplies them.  Both read a
compact form derived from the plan's own matrices, after
:func:`plan_weights` (so edge folding, normalization and the bf16
sum-keeping rounding stay where they are): :func:`compact_runs` gives each
output its band-relative first tap and a fixed-length run of weights (the
plain version walks it in tap order); :func:`group_windows` gives each
group of four outputs one shared window (the kernel's register tile).
Either holds every nonzero of the dense matrix, and a plan whose runs are
long (a hand-built plan, a steep downscale) only gets longer runs.

Two nonlinearities, height first only: the FSR dering clamp (each pass
clamped to the [min, max] of its output's two central taps, read through
the plan's ``center_v`` / ``center_h`` band offsets) and the uint8-quantized
intermediate.  Width-first configs with either run the height-first kernel
on the transposed image (:func:`transposed_cfg`, ``FusedOps.tr_ops``).
Integer-scale dering without a fused plan goes to kernel 2
(``resample_shift_cuda``); the ``v1``/``v2`` variants, which ask for no
fused plan, take kernel 2 for integer scales and v1
(``resample_phase_cuda``) for the rest.

On a CUDA tensor :func:`fused_call` launches the kernel; on a CPU tensor it
runs :func:`fused_resample_reference`, which walks the same plan.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from lanczos_torch.core.config import EdgeMode, Order, Precision, ResampleConfig
from lanczos_torch.core.config import reduced_scale
from lanczos_torch.core.weights import banded_weights
from lanczos_torch.ops import _build
from lanczos_torch.ops._fma import gather_sum
from lanczos_torch.ops.resample_phase_cuda import PhaseOps, phase_call
from lanczos_torch.ops.resample_shift_cuda import (
    GATHER, ShiftOps, integer_scale, shift_call,
)

# Launches of the fused kernel by this process, per instantiation; only
# fused_call adds to it, where it launches.
launches = {
    f"fused_resample_{p}{d}{q}": 0
    for p in ("fp32", "bf16") for d in ("", "_dering") for q in ("", "_quant")
}



def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class FusedPlan:
    """Tiles, band starts and dense weights of one fused resample.

    ``wv`` is ``(num_tiles, tile_out, kv)`` and ``wh`` is
    ``(n_uniq, kh, cb)``, both float64; ``starts_v``, ``starts_h`` and
    ``uniq_h`` are int32 arrays computed on the host.  A dering plan also
    carries, per tile and per unique block, the band-relative positions of
    each output's two central taps (``op.idx[:, s-1]``, ``op.idx[:, s]``
    less the band start, ``s`` the support per side): ``center_v``
    ``(num_tiles, 2, tile_out)`` and ``center_h`` ``(n_uniq, 2, cb)``,
    int32, zero past a ragged edge.  ``win_v``, where not 0, is the least
    length of the vertical pass's shared windows (the row-sharded path
    gives every shard's plan one length).  Compared by identity (it keys
    the reference's table cache)."""

    tile_out: int
    kv: int
    num_tiles: int
    starts_v: np.ndarray  # (num_tiles,) first input row of each tile's band
    cb: int
    kh: int
    n_cb: int
    starts_h: np.ndarray  # (n_cb,) first intermediate column of each block
    uniq_h: np.ndarray  # (n_cb,) index into wh
    wv: np.ndarray
    wh: np.ndarray
    center_v: Optional[np.ndarray] = None
    center_h: Optional[np.ndarray] = None
    win_v: int = 0

    def smem_bytes(self) -> int:
        """Shared memory one block of the CUDA kernel needs (its launcher's
        sum: the uint8 band, the fp32 intermediate, the uint8 output tile
        staged for 16-byte stores, and the block's tables: its window
        weights and bases, and a dering plan's central-tap offsets)."""
        win_v, win_h = _window_lengths(self)
        sizes = smem_layout(self.tile_out, self.kv, self.cb, self.kh)
        tile_p, cb_p = sizes["tile_p"], sizes["cb_p"]
        tables = 4 * (win_v * tile_p + win_h * cb_p) + tile_p + cb_p
        if self.center_v is not None:
            tables += 8 * (tile_p + cb_p)
        return sizes["band"] + sizes["mid"] + sizes["stage"] + tables


def smem_layout(tile: int, kv: int, cb: int, kh: int) -> dict:
    """Sizes of the band, the intermediate and the staged tile in one
    block's shared memory, as the kernel lays them out.

    ``mw``: columns of the intermediate, which starts at the 8-column
    boundary at or below the block's first tap (so up to 7 columns before
    it).  ``bw``: bytes of a band row: the band starts at the 16-byte
    boundary at or below ``starts_h[b]``, so up to 8 more; a stride that is
    a multiple of 32 bytes would put every fourth row on the same banks, so
    such a stride grows by 16.  ``stage_w``: bytes of a staged output row, a
    power of two of 16-byte chunks (the kernel swizzles chunks by row)."""
    tile_p, cb_p = _round_up(tile, 8), _round_up(cb, 4)
    mw = _round_up(kh + 7, 8)
    bw = _round_up(mw + 8, 16)
    if bw % 32 == 0:
        bw += 16
    chunks = 1 << (-(-cb_p // 16) - 1).bit_length()
    stage_w = 16 * chunks
    return dict(
        tile_p=tile_p, cb_p=cb_p, bw=bw, mw=mw, stage_w=stage_w,
        band=kv * bw, mid=4 * mw * tile_p, stage=tile_p * stage_w,
    )


def _block_width(nh: int, cb_target: int) -> int:
    """Output columns per block: the largest multiple of lcm(N, 4) up to
    ``cb_target``, so interior blocks share one matrix (block starts step
    by an integral ``cb·D/N``) and rows stay 16-byte aligned; a phase count
    too large for that gets ``cb_target`` and one matrix per block."""
    unit = nh * 4 // math.gcd(nh, 4)
    return (cb_target // unit) * unit if unit <= cb_target else cb_target


def build_fused_plan(
    cfg: ResampleConfig,
    tile: int,
    op_v,
    op_h,
    nv: int,
    dv: int,
    off_v: int,
    cb_target: int = 128,
    kv: int = 0,
) -> Optional[FusedPlan]:
    """Plan from prebuilt banded operators (``_build_mxu_plan``'s meaning).

    ``cfg`` supplies the shapes and, through ``cfg.dering``, whether the
    plan carries the central-tap offsets.  The vertical band of tile ``i``
    starts at the exact rational floor ``(2·lo·dv + off_v)//(2·nv) −
    (op_v.a − 1)`` (Python floor division: with ``align="center"`` the
    numerator can be negative), clipped into the image, and is ``kv`` rows
    tall, no fewer than the ``kv`` given (the row-sharded path builds every
    shard's plan to one height); the horizontal band of block ``b`` starts
    at its lowest tap.  The offsets come from the
    operators' clipped indices, so drop-edge dering clamps to the edge
    pixels as the gather path does.  Returns None where a window cannot
    cover its tile or one block's band and intermediate exceed shared
    memory."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    nh = reduced_scale(iw, ow)[0]
    back_v = op_v.a - 1
    s_v, s_h = op_v.a, op_h.a

    # ---- vertical tiles ----
    tile = min(tile, oh)
    num = -(-oh // tile)

    def v_start_raw(lo: int) -> int:
        return (2 * lo * dv + off_v) // (2 * nv) - back_v

    for i in range(num):
        lo, hi = i * tile, min((i + 1) * tile, oh)
        kv = max(kv, int(op_v.idx[lo:hi].max()) - max(v_start_raw(lo), 0) + 1)
    starts_v = np.zeros(num, np.int32)
    wv = np.zeros((num, tile, kv), np.float64)
    center_v = np.zeros((num, 2, tile), np.int32) if cfg.dering else None
    for i in range(num):
        lo, hi = i * tile, min((i + 1) * tile, oh)
        start = min(max(v_start_raw(lo), 0), max(ih - kv, 0))
        band_idx = op_v.idx[lo:hi] - start
        if band_idx.min() < 0 or band_idx.max() >= kv:
            return None  # window cannot cover this tile
        rr = np.arange(hi - lo)
        np.add.at(wv[i], (rr[:, None], band_idx), op_v.weights[lo:hi])
        if cfg.dering:
            center_v[i, :, : hi - lo] = band_idx[:, s_v - 1 : s_v + 1].T
        starts_v[i] = start

    # ---- horizontal blocks ----
    cb = _block_width(nh, cb_target)
    n_cb = -(-ow // cb)
    kh = 0
    for b in range(n_cb):
        blk = op_h.idx[b * cb : min((b + 1) * cb, ow)]
        kh = max(kh, int(blk.max()) - int(blk.min()) + 1)
    starts_h = np.zeros(n_cb, np.int32)
    uniq_h = np.zeros(n_cb, np.int32)
    uniq: list = []  # (matrix, central-tap offsets): both key the dedup
    for b in range(n_cb):
        lo, hi = b * cb, min((b + 1) * cb, ow)
        start = min(int(op_h.idx[lo:hi].min()), max(iw - kh, 0))
        band_idx = op_h.idx[lo:hi] - start
        if band_idx.min() < 0 or band_idx.max() >= kh:
            return None
        w = np.zeros((kh, cb), np.float64)
        cc = np.arange(hi - lo)
        np.add.at(w, (band_idx, cc[:, None]), op_h.weights[lo:hi])
        c = np.zeros((2, cb), np.int32)
        if cfg.dering:
            c[:, : hi - lo] = band_idx[:, s_h - 1 : s_h + 1].T
        starts_h[b] = start
        for u, (seen_w, seen_c) in enumerate(uniq):
            if np.array_equal(w, seen_w) and np.array_equal(c, seen_c):
                uniq_h[b] = u
                break
        else:
            uniq_h[b] = len(uniq)
            uniq.append((w, c))

    plan = FusedPlan(
        tile_out=tile, kv=kv, num_tiles=num, starts_v=starts_v, cb=cb, kh=kh,
        n_cb=n_cb, starts_h=starts_h, uniq_h=uniq_h,
        wv=wv, wh=np.stack([w for w, _ in uniq]),
        center_v=center_v,
        center_h=np.stack([c for _, c in uniq]) if cfg.dering else None,
    )
    return plan if plan.smem_bytes() <= _build.SMEM_LIMIT else None


def _operators(cfg: ResampleConfig) -> tuple:
    """``build_fused_plan``'s operator arguments for a config: the banded
    operators of both axes, ``nv``, ``dv`` and the vertical offset."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    (nv, dv) = reduced_scale(ih, oh)
    kw = dict(
        a=cfg.a, filter_name=cfg.filter, edge_mode=cfg.edge_mode,
        normalize=cfg.normalize, coord_mode="exact", align=cfg.align.value,
    )
    off_v = 0 if cfg.align.value == "zero" else dv - nv
    return banded_weights(ih, oh, **kw), banded_weights(iw, ow, **kw), nv, dv, off_v


def plan_at(cfg: ResampleConfig, tile: int, cb: int = 128) -> Optional[FusedPlan]:
    """The fused plan at a given row tile and column block target, or None
    where it does not fit (the ablation harness's ``tile:variant`` specs,
    and hand-picked plans in tests)."""
    return build_fused_plan(cfg, tile, *_operators(cfg), cb)


@functools.lru_cache(maxsize=8)  # plans hold multi-MB float64 weight stacks
def fused_plan(cfg: ResampleConfig) -> Optional[FusedPlan]:
    """The fused plan of a whole-frame config, or None where none fits.

    Starts at 64-row tiles and 128-column blocks: the horizontal pass is
    then 256 threads of 8×4 outputs each, exactly, and a block's band
    carries 16% more rows and 8% more columns than its outputs need at 2×.
    Steep downscales, whose bands outgrow shared memory, retry with
    smaller tiles and blocks, down to 16 rows by 32 columns: an 8-row tile
    is one row group of the horizontal pass (4 busy threads a block), and
    what does not fit at 16 × 32 (a 1/16 thumbnail) is v1's.  A width-first
    config with dering or the quantized intermediate has no plan of its
    own: the kernel runs height first, and through a nonlinearity the
    order shows (``FusedOps`` runs its :func:`transposed_cfg`)."""
    if cfg.order != Order.HEIGHT_FIRST and (cfg.dering or cfg.intermediate_quantize):
        return None
    ops = _operators(cfg)
    for tile, cb in ((64, 128), (32, 64), (16, 32)):
        plan = build_fused_plan(cfg, tile, *ops, cb)
        if plan is not None:
            return plan
    return None


def plan_from_reference(fields: dict) -> FusedPlan:
    """The port's plan from a JAX ``_MXUPlan``'s fields (``vars(plan)``:
    ``wv``, ``wh``, ``starts_v``, ``starts_h``, ``uniq_h``, ``tile_out``,
    ``kv``, ``kh``, ``cb``, ``n_cb``, ``num_tiles``; others are ignored),
    so the port can run on exactly the matrices the TPU kernel used.  A
    dering plan's one-hot bound rows (``wv[:, t:2t]``, ``wv[:, 2t:3t]``)
    and columns (``wh[:, :, cb:2cb]``, ``wh[:, :, 2cb:3cb]``) become the
    central-tap offsets, read by argmax after checking that each is one-hot
    (or zero, past a ragged edge)."""
    tile, cb = int(fields["tile_out"]), int(fields["cb"])
    wv = np.asarray(fields["wv"], np.float64)
    wh = np.asarray(fields["wh"], np.float64)
    dering = (wv.shape[1], wh.shape[2]) == (3 * tile, 3 * cb)
    if not dering and (wv.shape[1], wh.shape[2]) != (tile, cb):
        raise ValueError(f"wv {wv.shape} and wh {wh.shape} fit no tile {tile}, block {cb}")
    centers = {}
    if dering:
        sel_v = np.stack([wv[:, tile : 2 * tile], wv[:, 2 * tile :]], axis=1)
        sel_h = np.stack([wh[:, :, cb : 2 * cb], wh[:, :, 2 * cb :]], axis=1)
        centers = dict(center_v=_one_hot_index(sel_v, 3), center_h=_one_hot_index(sel_h, 2))
    return FusedPlan(
        tile_out=tile, kv=int(fields["kv"]), num_tiles=int(fields["num_tiles"]),
        starts_v=np.asarray(fields["starts_v"], np.int32), cb=cb,
        kh=int(fields["kh"]), n_cb=int(fields["n_cb"]),
        starts_h=np.asarray(fields["starts_h"], np.int32),
        uniq_h=np.asarray(fields["uniq_h"], np.int32),
        wv=np.ascontiguousarray(wv[:, :tile]), wh=np.ascontiguousarray(wh[:, :, :cb]),
        **centers,
    )


def _one_hot_index(sel: np.ndarray, axis: int) -> np.ndarray:
    """Position of the one along ``axis`` of each one-hot selector (0 for an
    all-zero one); raises if any selector is neither."""
    ones, zeros = (sel == 1.0).sum(axis), (sel == 0.0).sum(axis)
    if not np.all((ones <= 1) & (ones + zeros == sel.shape[axis])):
        raise ValueError("dering bound rows or columns are not one-hot")
    return sel.argmax(axis).astype(np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _round_bf16(w: np.ndarray, axis: int) -> np.ndarray:
    """Round to bf16, keeping each output's tap sum (along ``axis``): the
    residual of every sum goes onto its largest tap, which is rounded
    again.  Plain rounding leaves normalized taps summing to 1 ± 2⁻⁹, a
    bias in proportion to brightness that flips about half of all pixels
    of a bright image by one LSB; keeping the sums flips about a fifth."""
    t = torch.from_numpy(np.asarray(w, np.float64))
    r = t.to(torch.bfloat16).double()
    resid = t.sum(axis, keepdim=True) - r.sum(axis, keepdim=True)
    r.scatter_add_(axis, r.abs().argmax(axis, keepdim=True), resid)
    return r.to(torch.bfloat16).float().numpy()


def plan_weights(plan: FusedPlan, precision: Precision) -> tuple:
    """``(wv, wh)`` as float32 arrays with the values the kernel uses: the
    plan's weights in fp32, or rounded to bf16 with each output row's
    (``wv``) and column's (``wh``) tap sum kept."""
    return _kernel_weights(plan.wv, 2, precision), _kernel_weights(plan.wh, 1, precision)


def _kernel_weights(w: np.ndarray, axis: int, precision: Precision) -> np.ndarray:
    if Precision(precision) == Precision.BF16:
        return _round_bf16(w, axis)
    return w.astype(np.float32)


GROUP = 4  # outputs that share one window in the kernel's register tile


def compact_runs(w: np.ndarray, length: int = 1) -> tuple:
    """The compact form of banded rows: ``w`` is ``(n, size, K)``, each row
    ``w[n, r]`` one run of nonzeros; returns ``first`` ``(n, size)`` int32,
    the band-relative first tap of each row, and ``taps`` ``(n, size, T)``,
    its run, ``T`` the longest run in ``w`` (at least ``length``, at most
    ``K``) and shorter runs zero-filled.  ``first`` is lowered where a run
    would pass ``K``, so every ``first + t`` is a valid band index; an
    all-zero row has first 0."""
    w = np.asarray(w)
    k = w.shape[-1]
    nz = w != 0
    has = nz.any(-1)
    first = np.where(has, nz.argmax(-1), 0)
    last = np.where(has, k - 1 - nz[..., ::-1].argmax(-1), -1)
    t = min(max(int((last - first + 1).max()), length, 1), k)
    first = np.minimum(first, k - t)
    taps = np.take_along_axis(w, first[..., None] + np.arange(t), -1)
    return first.astype(np.int32), np.ascontiguousarray(taps)


def group_windows(w: np.ndarray, group: int = GROUP, length: int = 1) -> tuple:
    """One shared window per ``group`` consecutive rows of ``w`` ``(n,
    size, K)`` (``size`` a multiple of ``group``): returns ``base`` ``(n,
    size/group)`` int32, the first band index any row of the group touches,
    and ``win`` ``(n, size/group, L, group)``, ``win[n, g, j, e] =
    w[n, group·g + e, base[n, g] + j]``, ``L`` the longest window in ``w``
    (at least ``length``, at most ``K``).  ``base`` is lowered where a
    window would pass ``K``."""
    w = np.asarray(w)
    n, size, k = w.shape
    wg = w.reshape(n, size // group, group, k)
    first, taps = compact_runs((wg != 0).any(2).astype(np.int8), length)
    idx = first[..., None] + np.arange(taps.shape[-1])  # (n, groups, L)
    win = np.take_along_axis(wg, idx[:, :, None, :], -1)  # (n, groups, group, L)
    return first, np.ascontiguousarray(np.swapaxes(win, 2, 3))


@functools.lru_cache(maxsize=16)
def _window_lengths(plan: FusedPlan) -> tuple:
    """``(win_v, win_h)`` of the plan's shared windows, from where its
    float64 weights are nonzero (no shorter than any precision's, nor than
    the plan's ``win_v``)."""
    def length(w: np.ndarray, least: int = 1) -> int:
        n, size, k = w.shape
        padded = np.zeros((n, _round_up(size, GROUP), k), bool)
        padded[:, :size] = w != 0
        return group_windows(padded, length=least)[1].shape[2]

    return length(plan.wv, plan.win_v), length(np.swapaxes(plan.wh, 1, 2))


def plan_runs(plan: FusedPlan, precision: Precision) -> tuple:
    """``(first_v, taps_v, first_h, taps_h)``: the compact form of
    :func:`plan_weights`' matrices, per output row of each tile
    ``(num_tiles, tile_out[, T_v])`` and per output column of each unique
    block ``(n_uniq, cb[, T_h])``."""
    wv, wh = plan_weights(plan, precision)
    return compact_runs(wv) + compact_runs(np.swapaxes(wh, 1, 2))


def _to_device(tables: list, device: str) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(torch.device(device))
                 for t in tables)


@functools.lru_cache(maxsize=16)
def _reference_vertical(plan: FusedPlan, precision: Precision, device: str):
    """The plain version's vertical tables: the input row of each output
    row's first tap, its run of taps and, for a dering plan, the input rows
    of its two bounds."""
    first_v, taps_v = compact_runs(_kernel_weights(plan.wv, 2, precision))
    starts_v = plan.starts_v.astype(np.int64)[:, None]
    tables = [(starts_v + first_v).reshape(-1), taps_v.reshape(-1, taps_v.shape[-1])]
    if plan.center_v is not None:
        tables.append((starts_v[:, None] + plan.center_v).transpose(1, 0, 2).reshape(2, -1))
    return _to_device(tables, device)


@functools.lru_cache(maxsize=8)
def _reference_horizontal(plan: FusedPlan, precision: Precision, device: str):
    """Likewise per output column: its first intermediate column, its run
    and the columns of its two bounds."""
    first_h, taps_h = compact_runs(np.swapaxes(_kernel_weights(plan.wh, 1, precision), 1, 2))
    uniq_h = plan.uniq_h.astype(np.int64)
    starts_h = plan.starts_h.astype(np.int64)[:, None]
    tables = [(starts_h + first_h[uniq_h]).reshape(-1), taps_h[uniq_h].reshape(-1, taps_h.shape[-1])]
    if plan.center_h is not None:
        center_h = plan.center_h.astype(np.int64)[uniq_h]
        tables.append((starts_h[:, None] + center_h).transpose(1, 0, 2).reshape(2, -1))
    return _to_device(tables, device)


def _tap_pass(x: torch.Tensor, first: torch.Tensor, taps: torch.Tensor, axis: int):
    """``Σ_t taps[:, t] · x[first + t]`` along ``axis``, in tap order, each
    tap rounded once in fp32 as the kernel's ``fmaf`` (:func:`gather_sum`)."""
    rows = first[:, None] + torch.arange(taps.shape[1], device=first.device)
    return gather_sum(x, axis, rows, taps)


def _clamp_between(v: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(v, min(a, b), max(a, b))``, as the kernel's fminf/fmaxf."""
    return torch.minimum(torch.maximum(v, torch.minimum(a, b)), torch.maximum(a, b))


def _trunc_clip(v: torch.Tensor) -> torch.Tensor:
    return torch.trunc(torch.clamp(v, 0.0, 255.0))


def fused_resample_reference(
    x: torch.Tensor, plan: FusedPlan, precision: Precision | str = Precision.FP32,
    out_shape: Optional[tuple] = None, dering: bool = False, quantize: bool = False,
    wv: Optional["VerticalTables"] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: (NC, H, W) uint8 →
    (NC, OH, OW) uint8 on the same tiles, starts and deduplicated blocks,
    walking the compact form (:func:`plan_runs`) in tap order.

    In the TPU kernel's order: the vertical sums; with ``dering``, the
    clamp to their two central band values; with ``quantize``,
    ``trunc(clip(·, 0, 255))``; in bf16, the intermediate's rounding to
    bf16; the horizontal sums; with ``dering``, the clamp to the two
    central values of the stored (rounded) intermediate; the output's
    ``trunc(clip(·, 0, 255))``, cut to ``out_shape`` (default: the plan's
    tile and block grid).  fp32: fp32 weights, intermediate and sums.
    bf16: weights rounded to bf16 (:func:`plan_weights`), sums in fp32.

    The kernel takes the same sums over the same taps in the same order,
    each tap one ``fmaf`` as here (:func:`gather_sum`), and gives identical
    bytes.

    ``wv`` (one shard's :class:`VerticalTables`) replaces the plan's
    vertical pass with the shard's, as :func:`fused_call`'s ``wv=`` does."""
    precision = Precision(precision)
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (NC, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    vplan = plan if wv is None else wv.plan
    if dering and (vplan.center_v is None or plan.center_h is None):
        raise ValueError("dering needs a plan with central-tap offsets")
    nc, h, w = x.shape
    rows, taps_v, *bounds_v = _reference_vertical(vplan, precision, str(x.device))
    cols, taps_h, *bounds_h = _reference_horizontal(plan, precision, str(x.device))
    centers = bounds_v + bounds_h if dering else []
    # zero beyond the image, as the kernel's masked band loads
    hp = max(h, int(rows.max()) + taps_v.shape[1])
    wp = max(w, int(cols.max()) + taps_h.shape[1])
    xf = torch.zeros((nc, hp, wp), dtype=torch.float32, device=x.device)
    xf[:, :h, :w] = x
    mid = _tap_pass(xf, rows, taps_v, 1)  # (nc, num_tiles * tile, wp)
    if dering:
        mid = _clamp_between(mid, xf[:, centers[0][0]], xf[:, centers[0][1]])
    if quantize:
        mid = _trunc_clip(mid)
    if precision == Precision.BF16:
        mid = mid.to(torch.bfloat16).to(torch.float32)
    y = _tap_pass(mid, cols, taps_h, 2)  # (nc, num_tiles * tile, n_cb * cb)
    if dering:
        y = _clamp_between(y, mid[..., centers[1][0]], mid[..., centers[1][1]])
    if out_shape is not None:
        y = y[:, : out_shape[0], : out_shape[1]]
    return _trunc_clip(y).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def kernel_layout(plan: FusedPlan, precision: Precision) -> dict:
    """Host arrays in the CUDA kernel's layout, and its integer launch
    arguments.

    The weights are :func:`group_windows` of :func:`plan_weights`' matrices,
    rows padded with zeros to ``tile_p = round_up(tile, 8)`` and columns to
    ``cb_p = round_up(cb, 4)``, step-major so that the threads of a warp
    read neighbouring 16-byte groups: ``wv (num_tiles, win_v, tile_p/4, 4)``
    with ``base_v (num_tiles, tile_p/4)``, ``wh (n_uniq, win_h, cb_p/4, 4)``
    with ``base_h (n_uniq, cb_p/4)``, fp32 in both precisions (bf16 weights
    are fp32 values that bf16 holds).  Then the int32 starts, for a dering
    plan the central-tap offsets ``cv (num_tiles, 2, tile_p)`` and ``ch
    (n_uniq, 2, cb_p)`` zero-padded alike, and :func:`smem_layout`'s
    sizes.  The vertical half is :func:`vertical_layout`'s."""
    tile, cb = plan.tile_out, plan.cb
    sizes = smem_layout(tile, plan.kv, cb, plan.kh)
    cb_p = sizes["cb_p"]
    wh = _kernel_weights(plan.wh, 1, precision)
    whp = np.zeros((wh.shape[0], cb_p, plan.kh), np.float32)
    whp[:, :cb] = np.swapaxes(wh, 1, 2)
    base_h, win_h = group_windows(whp)
    centers = {}
    if plan.center_h is not None:
        ch = np.zeros((wh.shape[0], 2, cb_p), np.int32)
        ch[:, :, :cb] = plan.center_h
        centers = dict(ch=ch)
    return dict(
        vertical_layout(plan, precision),
        wh=np.ascontiguousarray(np.swapaxes(win_h, 1, 2)), base_h=base_h,
        starts_h=plan.starts_h.astype(np.int32),
        uniq_h=plan.uniq_h.astype(np.int32),
        tile=tile, cb=cb, cb_p=cb_p, kh=plan.kh,
        win_h=win_h.shape[2], bw=sizes["bw"], mw=sizes["mw"],
        stage_w=sizes["stage_w"], n_cb=plan.n_cb,
        **centers,
    )


VERTICAL_FIELDS = ("kv", "tile_p", "win_v", "num_tiles")  # what a shard's tables must share


def vertical_layout(plan: FusedPlan, precision: Precision) -> dict:
    """The vertical half of :func:`kernel_layout`: ``wv``, ``base_v``,
    ``starts_v`` and, for a dering plan, ``cv``, with the integer fields of
    :data:`VERTICAL_FIELDS`.  The windows are at least ``plan.win_v``
    long."""
    tile_p = _round_up(plan.tile_out, 8)
    wv = _kernel_weights(plan.wv, 2, precision)
    wvp = np.zeros((plan.num_tiles, tile_p, plan.kv), np.float32)
    wvp[:, : plan.tile_out] = wv
    base_v, win_v = group_windows(wvp, length=plan.win_v)
    lay = dict(
        wv=np.ascontiguousarray(np.swapaxes(win_v, 1, 2)), base_v=base_v,
        starts_v=plan.starts_v.astype(np.int32),
        kv=plan.kv, tile_p=tile_p, win_v=win_v.shape[2], num_tiles=plan.num_tiles,
    )
    if plan.center_v is not None:
        cv = np.zeros((plan.num_tiles, 2, tile_p), np.int32)
        cv[:, :, : plan.tile_out] = plan.center_v
        lay["cv"] = cv
    return lay


@functools.lru_cache(maxsize=8)
def _vertical_fields(plan: FusedPlan, precision: Precision) -> dict:
    lay = vertical_layout(plan, precision)
    return {k: lay[k] for k in VERTICAL_FIELDS}


@dataclasses.dataclass(frozen=True, eq=False)
class VerticalTables:
    """One row shard's vertical tables for a plan every shard shares
    (``fused_call(ops, x, wv=tables)``; the port of the ``wv=`` override of
    ``_fused_call_mxu``): ``plan`` is the shard's own plan, whose vertical
    fields (``wv``, ``starts_v``, ``center_v``) are the tables' source and
    whose horizontal fields equal the shared plan's; ``fields`` its
    :data:`VERTICAL_FIELDS`, which must equal the shared plan's; ``tensors``
    the kernel's ``wv``, ``base_v``, ``starts_v`` (and ``cv``) on a CUDA
    device, None on the CPU, where the plain version reads ``plan``."""

    plan: FusedPlan
    precision: Precision
    fields: dict
    tensors: Optional[dict]


def vertical_tables(plan: FusedPlan, precision: Precision, device="cuda") -> VerticalTables:
    """A shard's :class:`VerticalTables` on ``device``."""
    device = torch.device(device)
    lay = vertical_layout(plan, precision)
    tensors = None
    if device.type == "cuda":
        tensors = {k: torch.from_numpy(v).to(device)
                   for k, v in lay.items() if isinstance(v, np.ndarray)}
    return VerticalTables(plan, Precision(precision),
                          {k: lay[k] for k in VERTICAL_FIELDS}, tensors)


def _check_plan(plan: FusedPlan, cfg: ResampleConfig) -> None:
    """Refuse a hand-built plan the kernel would read out of bounds with,
    or that leaves output pixels unwritten."""
    (oh, ow) = cfg.out_shape
    n_uniq = plan.wh.shape[0]
    ok = (
        plan.wv.shape == (plan.num_tiles, plan.tile_out, plan.kv)
        and plan.wh.shape[1:] == (plan.kh, plan.cb)
        and plan.starts_v.shape == (plan.num_tiles,)
        and plan.starts_h.shape == plan.uniq_h.shape == (plan.n_cb,)
        and plan.num_tiles * plan.tile_out >= oh
        and plan.n_cb * plan.cb >= ow
        and plan.starts_v.min() >= 0 and plan.starts_h.min() >= 0
        and plan.uniq_h.min() >= 0 and plan.uniq_h.max() < n_uniq
        and plan.smem_bytes() <= _build.SMEM_LIMIT
    )
    if ok and cfg.dering:
        cv, ch = plan.center_v, plan.center_h
        ok = (
            cv is not None and ch is not None
            and cv.shape == (plan.num_tiles, 2, plan.tile_out)
            and ch.shape == (n_uniq, 2, plan.cb)
            and cv.min() >= 0 and cv.max() < plan.kv
            and ch.min() >= 0 and ch.max() < plan.kh
        )
    if not ok:
        raise ValueError(f"plan does not fit the kernel or the {oh}x{ow} output")


def transposed_cfg(cfg: ResampleConfig) -> ResampleConfig:
    """The height-first config whose result on the transposed image is this
    width-first config's result, transposed: swapping both shape axes
    swaps which pass is vertical, and the dering clamp and the quantized
    intermediate act per value after each pass, so they commute with the
    transpose."""
    return dataclasses.replace(
        cfg,
        in_shape=(cfg.in_shape[1], cfg.in_shape[0]),
        out_shape=(cfg.out_shape[1], cfg.out_shape[0]),
        order=Order.HEIGHT_FIRST,
    )


VARIANTS = ("auto", "mxu", "v2", "v1")


def _v2_auto(cfg: ResampleConfig) -> bool:
    """Where ``auto`` falls back to kernel 2 when no fused plan fits
    (``lanczos_tpu/models/upscaler.py``'s ``_pallas_auto_eligible``):
    height-first integer-scale dering without drop edges or quantize."""
    return (
        cfg.dering
        and cfg.order == Order.HEIGHT_FIRST
        and cfg.edge_mode != EdgeMode.DROP
        and not cfg.intermediate_quantize
        and integer_scale(cfg)
    )


def _plan_cfg(cfg: ResampleConfig) -> ResampleConfig:
    """The config whose fused plan runs ``cfg``: its :func:`transposed_cfg`
    for width-first dering or quantize, else itself."""
    if cfg.order != Order.HEIGHT_FIRST and (cfg.dering or cfg.intermediate_quantize):
        return transposed_cfg(cfg)
    return cfg


def pallas_variant(cfg: ResampleConfig) -> str:
    """The variant ``PallasOps(variant="auto")`` runs on a TPU, for
    ``Upscaler(cfg, backend="pallas")``: ``"mxu"`` where a fused plan fits,
    else ``"v1"`` (kernel 2 for an integer config, v1 for the rest)."""
    return "mxu" if fused_plan(_plan_cfg(cfg)) is not None else "v1"


def _no_plan(cfg: ResampleConfig) -> str:
    kind = " and ".join(
        name for on, name in ((cfg.dering, "dering"),
                              (cfg.intermediate_quantize, "quantized intermediate"))
        if on
    ) or "linear"
    return (
        f"no fused plan fits this {kind} config (a band outgrows shared "
        f"memory) and v2 does not take it; {GATHER}"
    )


class FusedOps:
    """One config's kernel, plan and weights on one device.

    ``variant`` picks the kernel as ``PallasOps`` does: ``"auto"`` the
    fused kernel where a plan fits (linear or nonlinear), else kernel 2 for
    height-first integer-scale dering (:func:`_v2_auto`); ``"mxu"`` the
    fused kernel or ``NotImplementedError``; ``"v2"`` and ``"v1"`` alike
    no fused plan: kernel 2 (``resample_shift_cuda.ShiftOps``) where D = 1
    and N <= 16 on both axes (``PallasOps.v2``), else v1
    (``resample_phase_cuda.PhaseOps``), each raising where ``PallasOps``
    raises.  A width-first config with dering or the quantized
    intermediate holds the ops of its :func:`transposed_cfg` (``tr_ops``)
    and runs on the transposed image.  ``plan`` is a hand-built fused plan
    (checked against the config); ``design`` goes to v1's ``PhaseOps``
    (``"generic"`` forces its first design: tests and timing).

    ``variant`` (``"mxu"``, ``"v2"`` or ``"v1"``) and ``kernel`` then name
    what runs; of ``plan`` (the fused plan), ``shift`` (kernel 2's ops) and
    ``phase`` (v1's ops) one is set and the others are None.  On CUDA the
    fused weights are uploaded once in the kernel's layout
    (:func:`kernel_layout`); on the CPU the plain versions run."""

    def __init__(
        self, cfg: ResampleConfig, device="cuda", plan: Optional[FusedPlan] = None,
        variant: str = "auto", design: str = "auto",
    ):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError(
                "the bit-exact profiles run on their own integer paths, as "
                "PallasOps refuses them: hls on ops.fixed_point.HLSOps, "
                "c_oracle on ops.c_exact.CExactOps (Upscaler routes both)"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.tr_ops = self.shift = self.phase = self.tensors = self.args = None
        tcfg = _plan_cfg(cfg)
        if tcfg is not cfg:
            if variant == "auto" and plan is None and fused_plan(tcfg) is None:
                raise NotImplementedError(_no_plan(cfg))
            self.tr_ops = FusedOps(tcfg, self.device, plan, variant, design)
            for k in ("plan", "shift", "phase", "variant", "kernel"):
                setattr(self, k, getattr(self.tr_ops, k))
            return
        if variant in ("auto", "mxu"):
            if plan is None:
                plan = fused_plan(cfg)
            else:
                _check_plan(plan, cfg)
            if plan is None and (variant == "mxu" or not _v2_auto(cfg)):
                raise NotImplementedError(_no_plan(cfg))
        else:
            plan = None
        self.plan = plan
        if plan is None:
            if integer_scale(cfg):
                self.variant, self.kernel = "v2", "shift_resample"
                self.shift = ShiftOps(cfg, self.device)
            else:
                self.phase = PhaseOps(cfg, self.device, design=design)
                self.variant, self.kernel = "v1", self.phase.kernel
            return
        bf16 = cfg.precision == Precision.BF16
        self.variant = "mxu"
        self.kernel = (
            f"fused_resample_{'bf16' if bf16 else 'fp32'}"
            f"{'_dering' if cfg.dering else ''}"
            f"{'_quant' if cfg.intermediate_quantize else ''}"
        )
        if self.device.type == "cuda":
            if plan.num_tiles > 65535:
                raise ValueError(f"{plan.num_tiles} row tiles exceed gridDim.y")
            lay = kernel_layout(plan, cfg.precision)
            self.tensors = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in lay.items() if isinstance(v, np.ndarray)
            }
            self.args = {k: v for k, v in lay.items() if isinstance(v, int)}


def make_fused_ops(cfg: ResampleConfig, plan: FusedPlan, device="cuda") -> FusedOps:
    """FusedOps carrying a hand-built plan (the streaming chunk and
    row-sharded paths build theirs from window-rebased operators)."""
    return FusedOps(cfg, device, plan=plan)


def _check_tables(ops: FusedOps, wv: VerticalTables) -> None:
    """Refuse a shard's table set that does not fit ``ops``'s plan, naming
    the field."""
    if not isinstance(wv, VerticalTables):
        raise TypeError(f"wv= takes a shard's VerticalTables, got {type(wv).__name__}")
    cfg = ops.cfg
    if wv.precision != cfg.precision:
        raise ValueError(f"wv= tables are {wv.precision.value}, the plan {cfg.precision.value}")
    if (wv.plan.center_v is not None) != cfg.dering:
        raise ValueError(f"wv= tables {'lack' if cfg.dering else 'carry'} the central-tap "
                         "offsets cv")
    if wv.tensors is None and ops.device.type == "cuda":
        raise ValueError("wv= tables hold no device tensors: build them on the device")
    if wv.tensors is not None and wv.tensors["wv"].device != ops.device:
        raise ValueError(f"wv= tables on {wv.tensors['wv'].device}, weights on {ops.device}")
    mine = ops.args if ops.args is not None else _vertical_fields(ops.plan, cfg.precision)
    for k in VERTICAL_FIELDS:
        if wv.fields[k] != mine[k]:
            raise ValueError(f"wv= tables have {k}={wv.fields[k]}, the plan {k}={mine[k]}")


def fused_call(ops: FusedOps, x: torch.Tensor, wv: Optional[VerticalTables] = None
               ) -> torch.Tensor:
    """(NC, H, W) uint8 → (NC, OH, OW) uint8 on ``ops``'s device, through
    the fused kernel.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version.  ``wv``, one row shard's :class:`VerticalTables`,
    replaces the plan's vertical tables (``wv``, ``base_v``, ``starts_v``,
    ``cv``) in the launch; the horizontal tables and every integer argument
    stay ``ops``'s, and a table set whose ``kv``, ``tile_p``, ``win_v`` or
    ``num_tiles`` differ raises."""
    if ops.variant != "mxu" or ops.tr_ops is not None:
        raise ValueError(
            f"this config runs {ops.kernel}"
            f"{' on the transposed image' if ops.tr_ops is not None else ''}: "
            "call upscale_planar"
        )
    cfg = ops.cfg
    (h, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    if x.dtype != torch.uint8 or x.dim() != 3 or tuple(x.shape[1:]) != (h, w):
        raise ValueError(
            f"expected (NC, {h}, {w}) uint8, got {tuple(x.shape)} {x.dtype}"
        )
    if x.device != ops.device:
        raise ValueError(f"input on {x.device}, weights on {ops.device}")
    if wv is not None:
        _check_tables(ops, wv)
    if x.device.type == "cpu":
        return fused_resample_reference(
            x, ops.plan, cfg.precision, (oh, ow), cfg.dering, cfg.intermediate_quantize, wv
        )
    if not x.is_contiguous():
        raise ValueError("the fused kernel needs a contiguous input")
    nc = x.shape[0]
    if nc > 65535:
        raise ValueError(f"{nc} planes exceed gridDim.z")
    lib = _build.library()
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=x.device)
    t, a = ops.tensors, ops.args
    if wv is not None:
        t = dict(t, **wv.tensors)
    centers = [t["cv"].data_ptr(), t["ch"].data_ptr()] if cfg.dering else [None, None]
    with torch.cuda.device(x.device):
        code = lib.lanczos_fused_resample(
            x.data_ptr(), out.data_ptr(), t["wv"].data_ptr(), t["wh"].data_ptr(),
            t["base_v"].data_ptr(), t["base_h"].data_ptr(),
            t["starts_v"].data_ptr(), t["starts_h"].data_ptr(),
            t["uniq_h"].data_ptr(), *centers, nc, h, w, oh, ow, a["tile"],
            a["tile_p"], a["kv"], a["cb"], a["cb_p"], a["kh"], a["win_v"], a["win_h"],
            a["bw"], a["mw"], a["stage_w"], a["n_cb"], a["num_tiles"],
            int(cfg.precision == Precision.BF16), int(cfg.dering),
            int(cfg.intermediate_quantize),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code)
    launches[ops.kernel] += 1
    return out


def upscale_planar(img: torch.Tensor, ops: FusedOps) -> torch.Tensor:
    """Planar path: (C, H, W) or (B, C, H, W) uint8 → same rank uint8,
    through the kernel ``ops`` names; a width-first nonlinear config on
    the transposed image, its result a transposed view."""
    if ops.tr_ops is not None:
        return upscale_planar(img.transpose(-1, -2), ops.tr_ops).transpose(-1, -2)
    batched = img.dim() == 4
    x = img if batched else img[None]
    b, c = x.shape[0], x.shape[1]
    x = x.reshape(b * c, *x.shape[2:]).contiguous()
    if ops.shift is not None:
        y = shift_call(ops.shift, x)
    elif ops.phase is not None:
        y = phase_call(ops.phase, x)
    else:
        y = fused_call(ops, x)
    y = y.reshape(b, c, *ops.cfg.out_shape)
    return y if batched else y[0]


def resample_2d_cuda(img: torch.Tensor, ops: FusedOps) -> torch.Tensor:
    """Interleaved API: (..., H, W, C) uint8 → (..., OH, OW, C) uint8,
    through planar layout at the boundary."""
    lead = img.shape[:-3]
    x = img.reshape((-1,) + tuple(img.shape[-3:])).permute(0, 3, 1, 2)
    y = upscale_planar(x, ops).permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))
