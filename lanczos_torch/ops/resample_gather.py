"""Separable resampling as per-tap gathers: the port of
``lanczos_tpu/ops/resample_xla.py`` (the ``"xla"`` backend).

The banded operator ``out[y] = Σ_j w[y,j] · x[idx[y,j]]`` is applied as 2a
``index_select`` gathers in tap order, each tap rounded once
(``ops._fma.gather_sum``): XLA's CPU backend contracts the JAX gather's tap
chain into FMAs, and so does this path, which keeps a constant plane
constant as the JAX one does.  An fp32 sum carries float64 temporaries
for it.  It is the portable reference path and the fallback for every float
config no kernel takes.  Every step is a plain tensor op, so autograd flows
through it.

The optional dering clamp reproduces the reference's FSR-inspired
anti-ringing step: clamp the accumulator to the [min, max] of the band's
two central taps (``worker.cpp:64-75``).

bf16 (``dtype=torch.bfloat16``) stores in bf16 and sums in fp32, as the
fused kernel's bf16 does: the weights rounded to bf16 keeping each
output's tap sum, the input and each pass's result rounded to bf16, every
product and sum in fp32, the uint8 output quantized from the fp32 sums.
The JAX package's bf16 gather rounds after every multiply and add, and on
uniform noise at 2/1 that lands up to 5 LSB from the exact result on 54%
of pixels, past its own bf16 contract (≤ 3 LSB on ≤ 50%).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lanczos_torch.core.config import Order, ResampleConfig
from lanczos_torch.core.weights import banded_weights
from lanczos_torch.ops._fma import gather_sum
from lanczos_torch.ops.resample_cuda import _clamp_between, _round_bf16


def quantize_uint8(x: torch.Tensor, dtype=torch.uint8) -> torch.Tensor:
    """The oracle's double→uint8 rule: saturate then truncate toward zero
    (``full_TB.h:29-37``)."""
    return torch.trunc(torch.clamp(x, 0.0, 255.0)).to(dtype)


def axis_shape(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def apply_banded(
    x: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    axis: int,
    a: Optional[int] = None,
    dering: bool = False,
) -> torch.Tensor:
    """Apply a banded operator along ``axis``.

    x: any float tensor; idx (out, 2a) int64; w (out, 2a) float, all on
    x's device.
    """
    axis = axis % x.dim()
    taps = idx.shape[1]
    acc = gather_sum(x, axis, idx, w)
    if dering:
        if a is None:
            a = taps // 2
        c0 = x.index_select(axis, idx[:, a - 1])
        c1 = x.index_select(axis, idx[:, a])
        acc = _clamp_between(acc, c0, c1)
    return acc


class SeparableOps:
    """The banded operators of one 2-D resample, on one device: ``idx_v``,
    ``idx_h`` (out, 2a) int64 and ``w_v``, ``w_h`` (out, 2a) in the compute
    dtype (for bf16: fp32 holding the bf16-rounded weights).
    A ``c_faithful`` config builds with the oracle's double coordinates, as
    the JAX ops do, but :func:`resample_2d_gather` refuses it."""

    def __init__(self, cfg: ResampleConfig, dtype=torch.float32, device="cpu"):
        coord = "c_double" if cfg.c_faithful else "exact"
        ops = [
            banded_weights(
                i, o, cfg.a, cfg.filter, cfg.edge_mode, cfg.normalize,
                coord_mode=coord, align=cfg.align.value,
            )
            for i, o in zip(cfg.in_shape, cfg.out_shape)
        ]
        w_v, w_h = ops[0].weights, ops[1].weights
        if dtype == torch.bfloat16:
            w_v, w_h = _round_bf16(w_v, 1), _round_bf16(w_h, 1)
        self._load(cfg, dtype, device, ops[0].idx, w_v, ops[1].idx, w_h)

    @classmethod
    def from_reference(cls, cfg: ResampleConfig, fields: dict, dtype=torch.float32,
                       device="cpu") -> "SeparableOps":
        """The ops from a JAX ``SeparableOps``' tables as numpy (``idx_v``,
        ``w_v``, ``idx_h``, ``w_h``), so the port runs on exactly its
        numbers."""
        ops = cls.__new__(cls)
        ops._load(cfg, dtype, device, *(
            np.asarray(fields[k], np.float32 if k[0] == "w" else np.int64)
            for k in ("idx_v", "w_v", "idx_h", "w_h")
        ))
        return ops

    def _load(self, cfg, dtype, device, idx_v, w_v, idx_h, w_h) -> None:
        self.cfg = cfg
        self.dtype = dtype  # the storage dtype
        self.compute = compute_dtype(dtype)
        self.device = torch.device(device)

        def put(a, dt):
            return torch.from_numpy(np.array(a)).to(self.device, dt)

        self.idx_v, self.idx_h = put(idx_v, torch.int64), put(idx_h, torch.int64)
        self.w_v, self.w_h = put(w_v, self.compute), put(w_h, self.compute)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype products and sums run in: fp32 for bf16 storage."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def store(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded to the storage ``dtype`` and back to its own."""
    return v.to(dtype).to(v.dtype) if dtype != v.dtype else v


def resample_2d_gather(img: torch.Tensor, ops: SeparableOps) -> torch.Tensor:
    """Separable 2-D resample of (..., H, W, C) per the ops' config.

    Returns uint8 if the input was an integer type (or
    ``intermediate_quantize`` is on), else the ops' float dtype.
    """
    cfg = ops.cfg
    if img.device != ops.device:
        raise ValueError(f"input on {img.device}, tables on {ops.device}")
    was_int = not img.is_floating_point()
    x = store(img.to(ops.compute), ops.dtype)
    h_axis, w_axis = img.dim() - 3, img.dim() - 2

    def vpass(v):
        # dering clamps against the BAND's central taps (taps//2 inside
        # apply_banded): for antialiased downscales support > a
        return apply_banded(v, ops.idx_v, ops.w_v, h_axis, dering=cfg.dering)

    def hpass(v):
        return apply_banded(v, ops.idx_h, ops.w_h, w_axis, dering=cfg.dering)

    def maybe_q(v):
        v = quantize_uint8(v, v.dtype) if cfg.intermediate_quantize else v
        return store(v, ops.dtype)

    if cfg.c_faithful:
        # the fp64-sequential truncation semantics are NOT reproducible in
        # float32 (see ops/c_exact.py, which the Upscaler routes to)
        raise NotImplementedError("c_faithful requires ops.c_exact.CExactOps")

    if cfg.order == Order.WIDTH_FIRST:
        x = vpass(maybe_q(hpass(x)))
    else:
        x = hpass(maybe_q(vpass(x)))

    if was_int or cfg.intermediate_quantize:
        return quantize_uint8(x)
    return x.to(ops.dtype)
