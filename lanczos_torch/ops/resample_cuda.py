"""Fused separable resampling on the H100: the plan, the kernel's wrapper
and its plain PyTorch version.

The port of ``lanczos_tpu/ops/resample_pallas.py``'s MXU variant
(``_build_mxu_plan``, ``_fused_call_mxu``, ``_fused_kernel_mxu``).  Both
passes are dense products over matrices built on the host from
:func:`banded_weights`, so edge modes, normalization and any rational N/D
live in the weights:

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

from lanczos_torch.core.config import Precision, ResampleConfig
from lanczos_torch.core.config import reduced_scale
from lanczos_torch.core.weights import banded_weights
from lanczos_torch.ops import _build

# Launches of the fused kernel by this process, per instantiation; only
# fused_call adds to it, where it launches.
launches = {"fused_resample_fp32": 0, "fused_resample_bf16": 0}

# Per-block shared memory of an H100 (the kernel's band + intermediate)
_SMEM_LIMIT = 227 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class FusedPlan:
    """Tiles, band starts and dense weights of one fused resample.

    ``wv`` is ``(num_tiles, tile_out, kv)`` and ``wh`` is
    ``(n_uniq, kh, cb)``, both float64; ``starts_v``, ``starts_h`` and
    ``uniq_h`` are int32 arrays computed on the host.  Compared by
    identity (it keys the reference's table cache)."""

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

    def smem_bytes(self) -> int:
        """Shared memory one block of the CUDA kernel needs."""
        kh_p = _round_up(self.kh, 8)
        return 4 * (self.kv * kh_p + kh_p * _round_up(self.tile_out, 8))


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

    ``cfg`` supplies the shapes.  The vertical band of tile ``i`` starts at
    the exact rational floor ``(2·lo·dv + off_v)//(2·nv) − (op_v.a − 1)``
    (Python floor division: with ``align="center"`` the numerator can be
    negative), clipped into the image; the horizontal band of block ``b``
    starts at its lowest tap.  Returns None where a window cannot cover its
    tile or one block's band and intermediate exceed shared memory."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    nh = reduced_scale(iw, ow)[0]
    back_v = op_v.a - 1

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
    for i in range(num):
        lo, hi = i * tile, min((i + 1) * tile, oh)
        start = min(max(v_start_raw(lo), 0), max(ih - kv, 0))
        band_idx = op_v.idx[lo:hi] - start
        if band_idx.min() < 0 or band_idx.max() >= kv:
            return None  # window cannot cover this tile
        rr = np.arange(hi - lo)
        np.add.at(wv[i], (rr[:, None], band_idx), op_v.weights[lo:hi])
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
    uniq: list = []
    for b in range(n_cb):
        lo, hi = b * cb, min((b + 1) * cb, ow)
        start = min(int(op_h.idx[lo:hi].min()), max(iw - kh, 0))
        band_idx = op_h.idx[lo:hi] - start
        if band_idx.min() < 0 or band_idx.max() >= kh:
            return None
        w = np.zeros((kh, cb), np.float64)
        cc = np.arange(hi - lo)
        np.add.at(w, (band_idx, cc[:, None]), op_h.weights[lo:hi])
        starts_h[b] = start
        for u, seen in enumerate(uniq):
            if np.array_equal(w, seen):
                uniq_h[b] = u
                break
        else:
            uniq_h[b] = len(uniq)
            uniq.append(w)

    plan = FusedPlan(
        tile_out=tile, kv=kv, num_tiles=num, starts_v=starts_v, cb=cb, kh=kh,
        n_cb=n_cb, starts_h=starts_h, uniq_h=uniq_h, wv=wv, wh=np.stack(uniq),
    )
    return plan if plan.smem_bytes() <= _SMEM_LIMIT else None


@functools.lru_cache(maxsize=8)  # plans hold multi-MB float64 weight stacks
def fused_plan(cfg: ResampleConfig) -> Optional[FusedPlan]:
    """The fused plan of a whole-frame config, or None where none fits.

    Starts at 64-row tiles and 128-column blocks: one block is then 256
    threads of 8×4 outputs each, exactly, and at 2× the dense products cost
    ~90 multiply-adds per output pixel.  Smaller tiles and blocks cut that
    (the dense windows shrink) but leave threads idle, and measured slower
    on the H100 (``PERF.md``).  Steep downscales, whose bands outgrow
    shared memory, retry with smaller tiles and blocks."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    (nv, dv) = reduced_scale(ih, oh)
    kw = dict(
        a=cfg.a, filter_name=cfg.filter, edge_mode=cfg.edge_mode,
        normalize=cfg.normalize, coord_mode="exact", align=cfg.align.value,
    )
    op_v = banded_weights(ih, oh, **kw)
    op_h = banded_weights(iw, ow, **kw)
    off_v = 0 if cfg.align.value == "zero" else dv - nv
    for tile, cb in ((64, 128), (32, 64), (16, 32), (8, 16)):
        plan = build_fused_plan(cfg, tile, op_v, op_h, nv, dv, off_v, cb)
        if plan is not None:
            return plan
    return None


def plan_from_reference(fields: dict) -> FusedPlan:
    """The port's plan from a JAX ``_MXUPlan``'s fields (``vars(plan)``:
    ``wv``, ``wh``, ``starts_v``, ``starts_h``, ``uniq_h``, ``tile_out``,
    ``kv``, ``kh``, ``cb``, ``n_cb``, ``num_tiles``; others are ignored),
    so the port can run on exactly the matrices the TPU kernel used.  The
    TPU's dering rows or columns (a ``wv`` taller than ``tile_out``, a
    ``wh`` wider than ``cb``) have no place in this plan and are refused."""
    tile, cb = int(fields["tile_out"]), int(fields["cb"])
    wv = np.asarray(fields["wv"], np.float64)
    wh = np.asarray(fields["wh"], np.float64)
    if wv.shape[1] != tile or wh.shape[2] != cb:
        raise NotImplementedError(
            "dering plans (one-hot bound rows/columns) come with the dering "
            "variant of the fused kernel (ROADMAP queue 2, item 1)"
        )
    return FusedPlan(
        tile_out=tile, kv=int(fields["kv"]), num_tiles=int(fields["num_tiles"]),
        starts_v=np.asarray(fields["starts_v"], np.int32), cb=cb,
        kh=int(fields["kh"]), n_cb=int(fields["n_cb"]),
        starts_h=np.asarray(fields["starts_h"], np.int32),
        uniq_h=np.asarray(fields["uniq_h"], np.int32), wv=wv, wh=wh,
    )


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
    starts_v = torch.from_numpy(plan.starts_v.astype(np.int64))
    starts_h = torch.from_numpy(plan.starts_h.astype(np.int64))
    return tuple(t.to(torch.device(device)) for t in (
        torch.from_numpy(wv),
        torch.from_numpy(wh)[torch.from_numpy(plan.uniq_h.astype(np.int64))],
        starts_v[:, None] + torch.arange(plan.kv),
        starts_h[:, None] + torch.arange(plan.kh),
    ))


def fused_resample_reference(
    x: torch.Tensor, plan: FusedPlan, precision: Precision | str = Precision.FP32,
    out_shape: Optional[tuple] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: (NC, H, W) uint8 →
    (NC, OH, OW) uint8 on the same tiles, starts and deduplicated blocks.

    fp32: fp32 weights, intermediate and sums.  bf16: weights rounded to
    bf16 (:func:`plan_weights`), the intermediate rounded to bf16 before
    the horizontal pass, sums in fp32 (the rounding points of the TPU
    kernel's bf16 mode).
    Output ``trunc(clip(y, 0, 255))``, cut to ``out_shape`` (default: the
    plan's tile and block grid).  On CUDA the caller must keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``): it would make this
    reference less exact than the kernel it checks."""
    precision = Precision(precision)
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (NC, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    nc, h, w = x.shape
    wv, wh, rows, cols = _reference_tables(plan, precision, str(x.device))
    # zero beyond the image, as the kernel's masked band loads
    hp = max(h, int(plan.starts_v.max()) + plan.kv)
    wp = max(w, int(plan.starts_h.max()) + plan.kh)
    xf = torch.zeros((nc, hp, wp), dtype=torch.float32, device=x.device)
    xf[:, :h, :w] = x
    band = xf[:, rows]  # (nc, num_tiles, kv, wp)
    mid = torch.matmul(wv, band)  # (nc, num_tiles, tile, wp)
    if precision == Precision.BF16:
        mid = mid.to(torch.bfloat16).to(torch.float32)
    mb = mid[..., cols]  # (nc, num_tiles, tile, n_cb, kh)
    y = torch.einsum("ntrbk,bkc->ntrbc", mb, wh)
    y = y.reshape(nc, plan.num_tiles * plan.tile_out, plan.n_cb * plan.cb)
    if out_shape is not None:
        y = y[:, : out_shape[0], : out_shape[1]]
    return torch.trunc(torch.clamp(y, 0.0, 255.0)).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def kernel_layout(plan: FusedPlan, precision: Precision) -> dict:
    """Host arrays in the CUDA kernel's layout: ``wvT (num_tiles, kv,
    tile_p)`` and ``wh (n_uniq, kh, cb_p)`` zero-padded to ``tile_p =
    round_up(tile, 8)`` and ``cb_p = round_up(cb, 4)``, the int32 starts,
    and the integer launch arguments (``kh_p = round_up(kh, 8)``)."""
    tile, cb = plan.tile_out, plan.cb
    tile_p, cb_p, kh_p = _round_up(tile, 8), _round_up(cb, 4), _round_up(plan.kh, 8)
    wv, wh = plan_weights(plan, precision)
    wvT = np.zeros((plan.num_tiles, plan.kv, tile_p), np.float32)
    wvT[:, :, :tile] = np.transpose(wv, (0, 2, 1))
    whp = np.zeros((wh.shape[0], plan.kh, cb_p), np.float32)
    whp[:, :, :cb] = wh
    return dict(
        wvT=wvT,
        wh=whp,
        starts_v=plan.starts_v.astype(np.int32),
        starts_h=plan.starts_h.astype(np.int32),
        uniq_h=plan.uniq_h.astype(np.int32),
        tile=tile, tile_p=tile_p, kv=plan.kv, cb=cb, cb_p=cb_p, kh=plan.kh,
        kh_p=kh_p, n_cb=plan.n_cb, num_tiles=plan.num_tiles,
    )


_NEXT_SLICE = {
    "dering": "the dering variant of the fused kernel (ROADMAP queue 2, item 1)",
    "intermediate_quantize": (
        "the quantized-intermediate variant of the fused kernel "
        "(ROADMAP queue 2, item 1)"
    ),
}


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
        and plan.smem_bytes() <= _SMEM_LIMIT
    )
    if not ok:
        raise ValueError(f"plan does not fit the kernel or the {oh}x{ow} output")


class FusedOps:
    """One config's plan and its weights on one device.

    On CUDA the weights are uploaded once in the kernel's layout (fp32, or
    bf16 for ``Precision.BF16``); on the CPU the plain version runs."""

    def __init__(
        self, cfg: ResampleConfig, device="cuda", plan: Optional[FusedPlan] = None
    ):
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError(
                "the bit-exact profiles (hls, c_oracle) come with their own "
                "slice (ROADMAP queue 1, item 6)"
            )
        for flag, slice_name in _NEXT_SLICE.items():
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag} configs come with {slice_name}")
        if plan is None:
            plan = fused_plan(cfg)
            if plan is None:
                raise NotImplementedError(
                    "no fused plan fits this config (a band outgrows shared "
                    "memory); the gather path takes it (ROADMAP queue 1, item 3)"
                )
        else:
            _check_plan(plan, cfg)
        self.cfg = cfg
        self.plan = plan
        self.device = torch.device(device)
        bf16 = cfg.precision == Precision.BF16
        self.kernel = "fused_resample_bf16" if bf16 else "fused_resample_fp32"
        self.tensors = self.args = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            if plan.num_tiles > 65535:
                raise ValueError(f"{plan.num_tiles} row tiles exceed gridDim.y")
            lay = kernel_layout(plan, cfg.precision)
            wdt = torch.bfloat16 if bf16 else torch.float32
            self.tensors = {
                k: torch.from_numpy(lay[k]).to(self.device, wdt)
                for k in ("wvT", "wh")
            } | {
                k: torch.from_numpy(lay[k]).to(self.device)
                for k in ("starts_v", "starts_h", "uniq_h")
            }
            self.args = {k: v for k, v in lay.items() if isinstance(v, int)}
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")


def make_fused_ops(cfg: ResampleConfig, plan: FusedPlan, device="cuda") -> FusedOps:
    """FusedOps carrying a hand-built plan (the streaming chunk and
    row-sharded paths build theirs from window-rebased operators)."""
    return FusedOps(cfg, device, plan=plan)


def fused_call(ops: FusedOps, x: torch.Tensor, wv=None) -> torch.Tensor:
    """(NC, H, W) uint8 → (NC, OH, OW) uint8 on ``ops``'s device.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version.  ``wv`` (per-shard vertical stacks) is the row-sharded
    slice's, not yet ported."""
    if wv is not None:
        raise NotImplementedError(
            "per-shard wv= stacks come with the row-sharded slice "
            "(ROADMAP queue 1, item 9)"
        )
    (h, w), (oh, ow) = ops.cfg.in_shape, ops.cfg.out_shape
    if x.dtype != torch.uint8 or x.dim() != 3 or tuple(x.shape[1:]) != (h, w):
        raise ValueError(
            f"expected (NC, {h}, {w}) uint8, got {tuple(x.shape)} {x.dtype}"
        )
    if x.device != ops.device:
        raise ValueError(f"input on {x.device}, weights on {ops.device}")
    if x.device.type == "cpu":
        return fused_resample_reference(x, ops.plan, ops.cfg.precision, (oh, ow))
    if not x.is_contiguous():
        raise ValueError("the fused kernel needs a contiguous input")
    nc = x.shape[0]
    if nc > 65535:
        raise ValueError(f"{nc} planes exceed gridDim.z")
    lib = _build.library()
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=x.device)
    t, a = ops.tensors, ops.args
    with torch.cuda.device(x.device):
        code = lib.lanczos_fused_resample(
            x.data_ptr(), out.data_ptr(), t["wvT"].data_ptr(), t["wh"].data_ptr(),
            t["starts_v"].data_ptr(), t["starts_h"].data_ptr(),
            t["uniq_h"].data_ptr(), nc, h, w, oh, ow, a["tile"], a["tile_p"],
            a["kv"], a["cb"], a["cb_p"], a["kh"], a["kh_p"], a["n_cb"],
            a["num_tiles"], int(ops.cfg.precision == Precision.BF16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code)
    launches[ops.kernel] += 1
    return out


def upscale_planar(img: torch.Tensor, ops: FusedOps) -> torch.Tensor:
    """Planar path: (C, H, W) or (B, C, H, W) uint8 → same rank uint8."""
    batched = img.dim() == 4
    x = img if batched else img[None]
    b, c = x.shape[0], x.shape[1]
    y = fused_call(ops, x.reshape(b * c, *x.shape[2:]).contiguous())
    y = y.reshape(b, c, *ops.cfg.out_shape)
    return y if batched else y[0]


def resample_2d_cuda(img: torch.Tensor, ops: FusedOps) -> torch.Tensor:
    """Interleaved API: (..., H, W, C) uint8 → (..., OH, OW, C) uint8,
    through planar layout at the boundary."""
    lead = img.shape[:-3]
    x = img.reshape((-1,) + tuple(img.shape[-3:])).permute(0, 3, 1, 2)
    y = upscale_planar(x, ops).permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))
