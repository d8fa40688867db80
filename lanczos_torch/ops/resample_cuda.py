"""Fused separable resampling on the H100: the plan, the kernel's wrapper,
its plain PyTorch version, and the routing between the port's kernels.

The port of ``lanczos_tpu/ops/resample_pallas.py``'s MXU variant
(``_build_mxu_plan``, ``_fused_call_mxu``, ``_fused_kernel_mxu``) and of
``PallasOps``'s choice of kernel.  Both passes are dense products over
matrices built on the host from :func:`banded_weights`, so edge modes,
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
    int32, zero past a ragged edge.  Compared by identity (it keys the
    reference's table cache)."""

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

    def smem_bytes(self) -> int:
        """Shared memory one block of the CUDA kernel needs (its launcher's
        sum: the band and the intermediate, whose rows a dering plan pads
        by 4 words)."""
        kh_p, pad = _round_up(self.kh, 8), 4 if self.center_v is not None else 0
        return 4 * (self.kv * (kh_p + pad) + kh_p * (_round_up(self.tile_out, 8) + pad))


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
) -> Optional[FusedPlan]:
    """Plan from prebuilt banded operators (``_build_mxu_plan``'s meaning).

    ``cfg`` supplies the shapes and, through ``cfg.dering``, whether the
    plan carries the central-tap offsets.  The vertical band of tile ``i``
    starts at the exact rational floor ``(2·lo·dv + off_v)//(2·nv) −
    (op_v.a − 1)`` (Python floor division: with ``align="center"`` the
    numerator can be negative), clipped into the image; the horizontal band
    of block ``b`` starts at its lowest tap.  The offsets come from the
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

    kv = 0
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

    Starts at 64-row tiles and 128-column blocks: one block is then 256
    threads of 8×4 outputs each, exactly, and at 2× the dense products cost
    ~90 multiply-adds per output pixel.  Smaller tiles and blocks cut that
    (the dense windows shrink) but leave threads idle, and measured slower
    on the H100 (``PERF.md``).  Steep downscales, whose bands outgrow
    shared memory, retry with smaller tiles and blocks.  A width-first
    config with dering or the quantized intermediate has no plan of its
    own: the kernel runs height first, and through a nonlinearity the
    order shows (``FusedOps`` runs its :func:`transposed_cfg`)."""
    if cfg.order != Order.HEIGHT_FIRST and (cfg.dering or cfg.intermediate_quantize):
        return None
    ops = _operators(cfg)
    for tile, cb in ((64, 128), (32, 64), (16, 32), (8, 16)):
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
    if Precision(precision) == Precision.BF16:
        return _round_bf16(plan.wv, 2), _round_bf16(plan.wh, 1)
    return plan.wv.astype(np.float32), plan.wh.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _reference_tables(plan: FusedPlan, precision: Precision, device: str):
    wv, wh = plan_weights(plan, precision)
    uniq_h = torch.from_numpy(plan.uniq_h.astype(np.int64))
    starts_v = torch.from_numpy(plan.starts_v.astype(np.int64))
    starts_h = torch.from_numpy(plan.starts_h.astype(np.int64))
    tables = [
        torch.from_numpy(wv),
        torch.from_numpy(wh)[uniq_h],
        starts_v[:, None] + torch.arange(plan.kv),
        starts_h[:, None] + torch.arange(plan.kh),
    ]
    if plan.center_v is not None:  # input rows and intermediate columns of the bounds
        tables.append(starts_v[:, None, None] + torch.from_numpy(plan.center_v.astype(np.int64)))
        center_h = torch.from_numpy(plan.center_h.astype(np.int64))[uniq_h]
        tables.append(starts_h[:, None, None] + center_h)
    return tuple(t.to(torch.device(device)) for t in tables)


def _clamp_between(v: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(v, min(a, b), max(a, b))``, as the kernel's fminf/fmaxf."""
    return torch.minimum(torch.maximum(v, torch.minimum(a, b)), torch.maximum(a, b))


def _trunc_clip(v: torch.Tensor) -> torch.Tensor:
    return torch.trunc(torch.clamp(v, 0.0, 255.0))


def fused_resample_reference(
    x: torch.Tensor, plan: FusedPlan, precision: Precision | str = Precision.FP32,
    out_shape: Optional[tuple] = None, dering: bool = False, quantize: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: (NC, H, W) uint8 →
    (NC, OH, OW) uint8 on the same tiles, starts and deduplicated blocks.

    In the TPU kernel's order: the vertical product; with ``dering``, the
    clamp to its two central band values; with ``quantize``,
    ``trunc(clip(·, 0, 255))``; in bf16, the intermediate's rounding to
    bf16; the horizontal product; with ``dering``, the clamp to the two
    central values of the stored (rounded) intermediate; the output's
    ``trunc(clip(·, 0, 255))``, cut to ``out_shape`` (default: the plan's
    tile and block grid).  fp32: fp32 weights, intermediate and sums.
    bf16: weights rounded to bf16 (:func:`plan_weights`), sums in fp32.
    On CUDA the caller must keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``): it would make this
    reference less exact than the kernel it checks."""
    precision = Precision(precision)
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (NC, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    if dering and plan.center_v is None:
        raise ValueError("dering needs a plan with central-tap offsets")
    nc, h, w = x.shape
    wv, wh, rows, cols, *centers = _reference_tables(plan, precision, str(x.device))
    # zero beyond the image, as the kernel's masked band loads
    hp = max(h, int(plan.starts_v.max()) + plan.kv)
    wp = max(w, int(plan.starts_h.max()) + plan.kh)
    xf = torch.zeros((nc, hp, wp), dtype=torch.float32, device=x.device)
    xf[:, :h, :w] = x
    band = xf[:, rows]  # (nc, num_tiles, kv, wp)
    mid = torch.matmul(wv, band)  # (nc, num_tiles, tile, wp)
    if dering:
        c = xf[:, centers[0]]  # (nc, num_tiles, 2, tile, wp)
        mid = _clamp_between(mid, c[:, :, 0], c[:, :, 1])
    if quantize:
        mid = _trunc_clip(mid)
    if precision == Precision.BF16:
        mid = mid.to(torch.bfloat16).to(torch.float32)
    mb = mid[..., cols]  # (nc, num_tiles, tile, n_cb, kh)
    y = torch.einsum("ntrbk,bkc->ntrbc", mb, wh)
    if dering:
        c = mid[..., centers[1]]  # (nc, num_tiles, tile, n_cb, 2, cb)
        y = _clamp_between(y, c[..., 0, :], c[..., 1, :])
    y = y.reshape(nc, plan.num_tiles * plan.tile_out, plan.n_cb * plan.cb)
    if out_shape is not None:
        y = y[:, : out_shape[0], : out_shape[1]]
    return _trunc_clip(y).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def kernel_layout(plan: FusedPlan, precision: Precision) -> dict:
    """Host arrays in the CUDA kernel's layout: ``wvT (num_tiles, kv,
    tile_p)`` and ``wh (n_uniq, kh, cb_p)`` zero-padded to ``tile_p =
    round_up(tile, 8)`` and ``cb_p = round_up(cb, 4)``, the int32 starts,
    for a dering plan the central-tap offsets ``cv (num_tiles, 2, tile_p)``
    and ``ch (n_uniq, 2, cb_p)`` zero-padded alike, and the integer launch
    arguments (``kh_p = round_up(kh, 8)``)."""
    tile, cb = plan.tile_out, plan.cb
    tile_p, cb_p, kh_p = _round_up(tile, 8), _round_up(cb, 4), _round_up(plan.kh, 8)
    wv, wh = plan_weights(plan, precision)
    wvT = np.zeros((plan.num_tiles, plan.kv, tile_p), np.float32)
    wvT[:, :, :tile] = np.transpose(wv, (0, 2, 1))
    whp = np.zeros((wh.shape[0], plan.kh, cb_p), np.float32)
    whp[:, :, :cb] = wh
    centers = {}
    if plan.center_v is not None:
        cv = np.zeros((plan.num_tiles, 2, tile_p), np.int32)
        cv[:, :, :tile] = plan.center_v
        ch = np.zeros((wh.shape[0], 2, cb_p), np.int32)
        ch[:, :, :cb] = plan.center_h
        centers = dict(cv=cv, ch=ch)
    return dict(
        wvT=wvT,
        wh=whp,
        starts_v=plan.starts_v.astype(np.int32),
        starts_h=plan.starts_h.astype(np.int32),
        uniq_h=plan.uniq_h.astype(np.int32),
        tile=tile, tile_p=tile_p, kv=plan.kv, cb=cb, cb_p=cb_p, kh=plan.kh,
        kh_p=kh_p, n_cb=plan.n_cb, num_tiles=plan.num_tiles,
        **centers,
    )


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
    (checked against the config).

    ``variant`` (``"mxu"``, ``"v2"`` or ``"v1"``) and ``kernel`` then name
    what runs; of ``plan`` (the fused plan), ``shift`` (kernel 2's ops) and
    ``phase`` (v1's ops) one is set and the others are None.  On CUDA the
    fused weights are uploaded once in the kernel's layout (fp32, or bf16
    for ``Precision.BF16``); on the CPU the plain versions run."""

    def __init__(
        self, cfg: ResampleConfig, device="cuda", plan: Optional[FusedPlan] = None,
        variant: str = "auto",
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
            self.tr_ops = FusedOps(tcfg, self.device, plan, variant)
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
                self.phase = PhaseOps(cfg, self.device)
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
            wdt = torch.bfloat16 if bf16 else torch.float32
            self.tensors = {
                k: torch.from_numpy(lay[k]).to(self.device, wdt)
                for k in ("wvT", "wh")
            } | {
                k: torch.from_numpy(lay[k]).to(self.device)
                for k in ("starts_v", "starts_h", "uniq_h", "cv", "ch")
                if k in lay
            }
            self.args = {k: v for k, v in lay.items() if isinstance(v, int)}


def make_fused_ops(cfg: ResampleConfig, plan: FusedPlan, device="cuda") -> FusedOps:
    """FusedOps carrying a hand-built plan (the streaming chunk and
    row-sharded paths build theirs from window-rebased operators)."""
    return FusedOps(cfg, device, plan=plan)


def fused_call(ops: FusedOps, x: torch.Tensor, wv=None) -> torch.Tensor:
    """(NC, H, W) uint8 → (NC, OH, OW) uint8 on ``ops``'s device, through
    the fused kernel.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version.  ``wv`` (per-shard vertical stacks) is the row-sharded
    slice's, not yet ported."""
    if wv is not None:
        raise NotImplementedError(
            "per-shard wv= stacks come with the row-sharded slice "
            "(ROADMAP queue 1, item 9)"
        )
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
    if x.device.type == "cpu":
        return fused_resample_reference(
            x, ops.plan, cfg.precision, (oh, ow), cfg.dering, cfg.intermediate_quantize
        )
    if not x.is_contiguous():
        raise ValueError("the fused kernel needs a contiguous input")
    nc = x.shape[0]
    if nc > 65535:
        raise ValueError(f"{nc} planes exceed gridDim.z")
    lib = _build.library()
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=x.device)
    t, a = ops.tensors, ops.args
    centers = [t["cv"].data_ptr(), t["ch"].data_ptr()] if cfg.dering else [None, None]
    with torch.cuda.device(x.device):
        code = lib.lanczos_fused_resample(
            x.data_ptr(), out.data_ptr(), t["wvT"].data_ptr(), t["wh"].data_ptr(),
            t["starts_v"].data_ptr(), t["starts_h"].data_ptr(),
            t["uniq_h"].data_ptr(), *centers, nc, h, w, oh, ow, a["tile"],
            a["tile_p"], a["kv"], a["cb"], a["cb_p"], a["kh"], a["kh_p"], a["n_cb"],
            a["num_tiles"], int(cfg.precision == Precision.BF16), int(cfg.dering),
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
