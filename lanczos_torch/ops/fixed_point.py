"""Vectorized HLS-faithful fixed-point path (int32 tensor ops): the port of
``lanczos_tpu/ops/fixed_point.py``.

Bit-exact reconstruction of the reference hardware pipeline's observable
output, validated against the literal stream simulator
(``lanczos_torch.ref.hls_sim``).  The streaming machine (cyclic line
buffer, quantized step predicate, zero pre-roll, saturate/replicate edges
— ``worker.cpp``, ``cyclic_buffer.h``) is flattened host-side into static
gather/LUT index tables by :func:`lanczos_torch.core.weights.hls_schedule`;
on the device the whole pipeline is 2·2a masked gathers + integer MACs:

- vertical MACs are exact in units of 2^-P (byte × P-frac weight);
- horizontal products have 2P fractional bits and are truncated to P per
  MAC (ap_fixed AP_TRN assignment, ``worker.cpp:91-97``) by an
  arithmetic shift, which floors a negative product as AP_TRN does;
- both passes apply the dering clamp against the two central window taps
  (``worker.cpp:64-75, 101-112``);
- the final byte conversion drops fractional bits (``worker.cpp:118-130``).

Integer arithmetic, so a CUDA tensor and a CPU tensor give the same bytes.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from lanczos_torch.core.config import ResampleConfig, reduced_scale
from lanczos_torch.core.weights import HLSSchedule, hls_lut, hls_schedule
from lanczos_torch.ops.resample_gather import axis_shape

_FIELDS = ("v_eff", "v_w", "v_valid", "h_eff", "h_w", "h_valid")


@dataclasses.dataclass
class HLSOps:
    """The tables of one HLS-faithful 2-D upscale, on one device."""

    cfg: ResampleConfig
    # vertical
    v_eff: torch.Tensor  # (OH, 2a) int64 source rows
    v_w: torch.Tensor  # (OH, 2a) int32 — LUT values gathered host-side
    v_valid: torch.Tensor  # (OH, 2a) int32 mask
    # horizontal
    h_eff: torch.Tensor
    h_w: torch.Tensor
    h_valid: torch.Tensor

    @classmethod
    def build(cls, cfg: ResampleConfig, lut_mode: str = "fp64", device="cpu") -> "HLSOps":
        P = cfg.bit_precision
        (in_h, in_w), (out_h, out_w) = cfg.in_shape, cfg.out_shape
        n_v, _ = reduced_scale(in_h, out_h)
        n_h, _ = reduced_scale(in_w, out_w)
        lut_v = hls_lut(cfg.a, n_v, P, lut_mode)
        lut_h = hls_lut(cfg.a, n_h, P, lut_mode)
        sv: HLSSchedule = hls_schedule(in_h, out_h, cfg.a, P)
        sh: HLSSchedule = hls_schedule(in_w, out_w, cfg.a, P)
        if sv.lut_overflow or sh.lut_overflow:
            warnings.warn(
                "HLS schedule indexes past the a*N ROM for this scale "
                "(a latent out-of-bounds in the reference hardware, "
                "core/weights.py lut_overflow); the clipped LUT used "
                "here may not match real hardware's undefined OOB read",
                RuntimeWarning,
                stacklevel=2,
            )
        return cls.from_reference(cfg, dict(
            v_eff=sv.eff_idx, v_w=lut_v[sv.lut_idx], v_valid=sv.valid,
            h_eff=sh.eff_idx, h_w=lut_h[sh.lut_idx], h_valid=sh.valid,
        ), device)

    @classmethod
    def from_reference(cls, cfg: ResampleConfig, fields: dict, device="cpu") -> "HLSOps":
        """The ops from numpy tables: a JAX ``HLSOps``' fields (``v_eff``,
        ``v_w``, ``v_valid``, ``h_eff``, ``h_w``, ``h_valid``) or the
        schedule's own."""
        device = torch.device(device)

        def put(k):
            dt = torch.int64 if k.endswith("eff") else torch.int32
            return torch.from_numpy(np.asarray(fields[k]).astype(np.int64)).to(device, dt)

        return cls(cfg=cfg, **{k: put(k) for k in _FIELDS})


def _clamp_central(acc, taps_list, a, scale_lo=0):
    c0, c1 = taps_list[a - 1], taps_list[a]
    lo = torch.minimum(c0, c1) << scale_lo
    hi = torch.maximum(c0, c1) << scale_lo
    return torch.minimum(torch.maximum(acc, lo), hi)


def hls_vertical_pass(x, eff, w, valid, a: int, P: int, axis: int):
    """Vertical HLS pass: int32 (..., H, ...) → num units 2^-P.

    Exact P-frac accumulation (byte × P-frac weight) + central-tap dering
    clamp (worker.cpp:45-78).  ``eff``/``w``/``valid`` are (OUT, 2a) rows
    of the flattened stream schedule; indices must already be local to x.
    """
    vals = []
    acc = None
    for j in range(2 * a):
        v = x.index_select(axis, eff[:, j]) * axis_shape(valid[:, j], x.dim(), axis)
        vals.append(v)
        term = axis_shape(w[:, j], x.dim(), axis) * v
        acc = term if acc is None else acc + term
    return _clamp_central(acc, vals, a, scale_lo=P)


def hls_horizontal_pass(mid, eff, w, valid, a: int, P: int, axis: int):
    """Horizontal HLS pass: num units → uint8; per-MAC truncation of
    2P-frac products to P frac (worker.cpp:91-97) + dering + byte clamp."""
    vals = []
    acc = None
    for j in range(2 * a):
        v = mid.index_select(axis, eff[:, j]) * axis_shape(valid[:, j], mid.dim(), axis)
        vals.append(v)
        term = (axis_shape(w[:, j], mid.dim(), axis) * v) >> P
        acc = term if acc is None else acc + term
    out = _clamp_central(acc, vals, a, scale_lo=0)
    return ((out >> P) & 0xFF).to(torch.uint8)


def hls_upscale(img: torch.Tensor, ops: HLSOps) -> torch.Tensor:
    """(..., H, W, C) uint8 → (..., OH, OW, C) uint8, HLS-path bit-exact."""
    if img.device != ops.v_w.device:
        raise ValueError(f"input on {img.device}, tables on {ops.v_w.device}")
    cfg = ops.cfg
    a, P = cfg.a, cfg.bit_precision
    h_axis, w_axis = img.dim() - 3, img.dim() - 2
    x = img.to(torch.int32)
    mid = hls_vertical_pass(x, ops.v_eff, ops.v_w, ops.v_valid, a, P, h_axis)
    return hls_horizontal_pass(mid, ops.h_eff, ops.h_w, ops.h_valid, a, P, w_axis)
