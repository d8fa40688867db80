"""The float64 separable gather: the exact reference of a ``precise``
config on the host, which the certification harness
(``lanczos_torch.tools.hwcert``) and ``chip_smoke.py`` hold the card to."""

from __future__ import annotations

import numpy as np

from lanczos_torch.core.weights import banded_weights


def gather_f64(img: np.ndarray, cfg) -> np.ndarray:
    """Float64 separable gather from the port's banded_weights: the
    (H, W, C) reference of a precise config, in its pass order, with its
    dering clamp (each pass to its two central taps) and its quantized
    intermediate; trunc-clipped to the input's integer type (uint8 or
    uint16), float64 for float input."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    kw = dict(a=cfg.a, filter_name=cfg.filter, edge_mode=cfg.edge_mode,
              normalize=cfg.normalize, align=cfg.align.value)
    op_v, op_h = banded_weights(ih, oh, **kw), banded_weights(iw, ow, **kw)

    def apply(x, op, axis):
        shape = [1, 1, 1]
        shape[axis] = op.out_size
        acc = None
        for j in range(op.taps):
            term = op.weights[:, j].reshape(shape) * np.take(x, op.idx[:, j], axis)
            acc = term if acc is None else np.add(acc, term, out=acc)
        if cfg.dering:
            c0 = np.take(x, op.idx[:, op.a - 1], axis)
            c1 = np.take(x, op.idx[:, op.a], axis)
            acc = np.clip(acc, np.minimum(c0, c1), np.maximum(c0, c1))
        return acc

    first, second = ((op_v, 0), (op_h, 1))
    if cfg.order.value == "width_first":
        first, second = second, first
    mid = apply(img.astype(np.float64), *first)
    if cfg.intermediate_quantize:
        # Exactly integral intermediates (at 2/1 the even rows copy the
        # input) come out of float64 a few ulps to either side, because
        # sin(pi*k) leaves the zero taps at ~1e-17; truncation would drop
        # those below by a whole level.  Snap them to the integer first.
        near = np.round(mid)
        mid = np.where(np.abs(mid - near) < 1e-9, near, mid)
        mid = np.trunc(np.clip(mid, 0.0, 255.0))
    out = apply(mid, *second)
    if img.dtype.kind == "f":
        return out
    top = float(np.iinfo(img.dtype).max)
    return np.trunc(np.clip(out, 0.0, top)).astype(img.dtype)
