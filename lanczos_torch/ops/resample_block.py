"""Blocked banded-matmul resampling for arbitrary scales: the port of
``lanczos_tpu/ops/resample_block_xla.py`` (the ``"block"`` backend).

The banded operator ``out = R · x`` is applied as a blocked dense product:

- output rows are tiled in blocks of ``T``; a block's taps cover a
  contiguous input span of ``S ≈ T·D/N + 2a`` rows, so the whole block is
  one dense ``(T × S) · (S × width)`` product, with the band's weights
  scattered into a per-tile ``(T, S)`` matrix at build time;
- nothing depends on N: a 1920→2001 resize (N=667) costs the same as 2×;
- edge modes, drop+normalize, per-phase weights and alignment live in the
  scattered weights, so every *linear* config is eligible; the (nonlinear)
  dering clamp is applied on top from two extra tap gathers.

Precision.  fp32 mode contracts the fp32 weights and the input in float64
and rounds to fp32: exact products whatever the global matmul flags say
(TF32 from ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision("high")`` would round the operands to
10 bits and drift 2–3 LSB, as the JAX package's default TPU precision
did), with no global state touched.  ``Precision.BF16`` splits the weights
into bf16 hi/lo parts and a float intermediate into bf16 hi/lo parts
(dropping ``lo·lo``), as the JAX package does; the parts are multiplied as
fp32, in which products of two bf16 values are exact (and TF32 represents
bf16 values exactly), accumulating in fp32.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from lanczos_torch.core.config import Order, Precision, ResampleConfig
from lanczos_torch.core.weights import BandedOperator, banded_weights
from lanczos_torch.ops.resample_cuda import _clamp_between
from lanczos_torch.ops.resample_gather import quantize_uint8


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


class _AxisBlock:
    """Blocked dense form of one axis' banded operator (host arrays)."""

    def __init__(self, op: BandedOperator, tile: int = 256, lane_pad: int = 8):
        out, taps = op.idx.shape
        T = min(tile, _pad_to(out, 8))
        n_tiles = -(-out // T)

        idx = op.idx.astype(np.int64)
        w = op.weights
        base = np.empty(n_tiles, np.int64)
        span = 0
        for t in range(n_tiles):
            rows = slice(t * T, min((t + 1) * T, out))
            base[t] = idx[rows].min()
            span = max(span, int(idx[rows].max() - base[t]) + 1)
        S = min(_pad_to(span, lane_pad), op.in_size)
        # pull bases back so every [base, base+S) window is in bounds
        base = np.clip(base, 0, op.in_size - S)

        Wt = np.zeros((n_tiles, T, S), np.float64)
        rows = np.arange(out)
        tt = rows // T
        rr = rows % T
        for j in range(taps):
            np.add.at(Wt, (tt, rr, idx[:, j] - base[tt]), w[:, j])
        self._set(dict(base=base, T=T, S=S, n_tiles=n_tiles, out_size=out,
                       weights64=Wt, idx=op.idx, taps=taps))

    @classmethod
    def from_reference(cls, fields: dict) -> "_AxisBlock":
        """From a JAX ``_AxisBlock``'s fields (``base``, ``T``, ``S``,
        ``n_tiles``, ``out_size``, ``weights64``, ``idx``, ``taps``)."""
        blk = cls.__new__(cls)
        blk._set(fields)
        return blk

    def _set(self, f: dict) -> None:
        # tile t reads the contiguous input span base[t] .. base[t]+S-1
        self.base = [int(b) for b in f["base"]]
        self.T, self.S, self.n_tiles = int(f["T"]), int(f["S"]), int(f["n_tiles"])
        self.out_size = int(f["out_size"])
        self.out_pad = self.n_tiles * self.T
        self.weights64 = np.array(f["weights64"], np.float64)
        self.idx = np.array(f["idx"], np.int64)  # for the dering tap gathers
        self.taps = int(f["taps"])

    def tables(self, split: bool, device) -> tuple:
        """``(w, None)``: the fp32 weights as float64; or ``(hi, lo)``: the
        bf16 split, as float32."""
        if split:
            w = torch.from_numpy(self.weights64)
            hi = w.to(torch.bfloat16)
            lo = (w - hi.double()).to(torch.bfloat16)
            return hi.float().to(device), lo.float().to(device)
        w = self.weights64.astype(np.float32).astype(np.float64)
        return torch.from_numpy(w).to(device), None


def _block_pass(x, axis: int, blk: _AxisBlock, tables, idx, dering: bool,
                exact_input: bool):
    """Apply the blocked operator along ``axis`` of x (uint8 or float;
    values are exact integers when ``exact_input``); float32 out."""
    axis = axis % x.dim()
    w_hi, w_lo = tables
    # stack the tiles' contiguous spans: (..., tiles, S, ...) at `axis`
    xt = torch.stack([x.narrow(axis, b, blk.S) for b in blk.base], dim=axis)
    xt = xt.to(torch.float64 if w_lo is None else torch.float32)

    letters = [c for c in string.ascii_lowercase if c not in "tos"]
    pre = "".join(letters[:axis])
    post = "".join(letters[axis : axis + (x.dim() - 1 - axis)])
    eq = f"tos,{pre}ts{post}->{pre}to{post}"

    def mm(w, v):
        return torch.einsum(eq, w, v)

    if w_lo is None:
        out = mm(w_hi, xt).to(torch.float32)
    elif exact_input:
        out = mm(w_hi, xt) + mm(w_lo, xt)  # integers up to 255 are bf16-exact
    else:
        x_hi = xt.to(torch.bfloat16).float()
        x_lo = (xt - x_hi).to(torch.bfloat16).float()
        out = mm(w_hi, x_hi) + (mm(w_lo, x_hi) + mm(w_hi, x_lo))
    del xt
    shape = list(x.shape)
    shape[axis] = blk.out_pad
    out = out.reshape(shape).narrow(axis, 0, blk.out_size)
    if dering:
        a = blk.taps // 2
        c0 = x.index_select(axis, idx[:, a - 1]).to(out.dtype)
        c1 = x.index_select(axis, idx[:, a]).to(out.dtype)
        out = _clamp_between(out, c0, c1)
    return out


class BlockOps:
    """The blocked operators of one linear config, on one device: ``wv``,
    ``wh`` (:meth:`_AxisBlock.tables`) and the tap indices ``idx_v``,
    ``idx_h`` (int64) for the dering clamp.  bf16 (``Precision.BF16``, or
    ``dtype=torch.bfloat16``) takes the split products."""

    def __init__(self, cfg: ResampleConfig, dtype=torch.float32, tile: int = 256,
                 device="cpu"):
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError("block path covers linear float configs only")
        blks = [
            _AxisBlock(banded_weights(
                i, o, cfg.a, cfg.filter, cfg.edge_mode, cfg.normalize,
                coord_mode="exact", align=cfg.align.value,
            ), tile)
            for i, o in zip(cfg.in_shape, cfg.out_shape)
        ]
        self._load(cfg, dtype, device, *blks)

    @classmethod
    def from_reference(cls, cfg: ResampleConfig, blk_v: dict, blk_h: dict,
                       dtype=torch.float32, device="cpu") -> "BlockOps":
        """The ops from a JAX ``BlockOps``' ``blk_v`` and ``blk_h`` fields
        as numpy (see :meth:`_AxisBlock.from_reference`), so the port
        contracts exactly its matrices."""
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError("block path covers linear float configs only")
        ops = cls.__new__(cls)
        ops._load(cfg, dtype, device, _AxisBlock.from_reference(blk_v),
                  _AxisBlock.from_reference(blk_h))
        return ops

    def _load(self, cfg, dtype, device, blk_v: _AxisBlock, blk_h: _AxisBlock) -> None:
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.precision == Precision.BF16 else dtype
        self.device = torch.device(device)
        self.split = self.dtype == torch.bfloat16
        self.blk_v, self.blk_h = blk_v, blk_h
        self.wv = blk_v.tables(self.split, self.device)
        self.wh = blk_h.tables(self.split, self.device)
        self.idx_v = torch.from_numpy(blk_v.idx).to(self.device)
        self.idx_h = torch.from_numpy(blk_h.idx).to(self.device)


def resample_2d_block(img: torch.Tensor, ops: BlockOps) -> torch.Tensor:
    """Separable 2D resample of (..., H, W, C) via blocked products:
    uint8 for integer input (or the quantized intermediate), else the ops'
    float dtype."""
    if img.device != ops.device:
        raise ValueError(f"input on {img.device}, tables on {ops.device}")
    cfg = ops.cfg
    was_int = not img.is_floating_point()
    x = img  # passes slice the raw (possibly uint8) tensor and widen tiles
    h_axis, w_axis = img.dim() - 3, img.dim() - 2

    def vpass(v, exact):
        return _block_pass(v, h_axis, ops.blk_v, ops.wv, ops.idx_v, cfg.dering, exact)

    def hpass(v, exact):
        return _block_pass(v, w_axis, ops.blk_h, ops.wh, ops.idx_h, cfg.dering, exact)

    def maybe_q(v):
        return quantize_uint8(v, torch.float32) if cfg.intermediate_quantize else v

    exact0 = was_int
    exact1 = cfg.intermediate_quantize
    if cfg.order == Order.WIDTH_FIRST:
        x = vpass(maybe_q(hpass(x, exact0)), exact1)
    else:
        x = hpass(maybe_q(vpass(x, exact0)), exact1)

    if was_int or cfg.intermediate_quantize:
        return quantize_uint8(x)
    return x.to(ops.dtype)  # match the gather/strided backends' dtype
