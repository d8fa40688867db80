"""The plain reference: a separable Lanczos resample in float64, written from
the configuration file alone.

It imports nothing of the program.  Each output sample ``y`` of an axis of
``n_in`` inputs and ``n_out`` outputs sits at the input coordinate
``x = y·n_in/n_out`` (``align: "zero"``) or ``(y + ½)·n_in/n_out − ½``
(``"center"``); its taps are the inputs ``i = ⌊x⌋ − a + 1 … ⌊x⌋ + a``, each
weighted ``sinc(x − i)·sinc((x − i)/a)`` (the normalized sinc), read at
the nearest edge sample where ``i`` lies outside (``edge_mode: "clamp"``),
and the weights of a sample are divided by their sum (``normalize``).  The
two axes are applied one after the other in float64, so the result is the
exact real value of the linear filter, to float64 rounding, whichever axis
goes first.  A uint8 output byte stands for ``trunc(clip(r, 0, 255))`` of
that value ``r``.
"""

from __future__ import annotations

import numpy as np
import torch

SUPPORTED = dict(filter="lanczos", edge_mode="clamp", dering=False,
                 intermediate_quantize=False)


def check_semantics(conf: dict) -> None:
    """Raise where the configuration asks for what this reference does not
    compute."""
    for key, want in SUPPORTED.items():
        if conf[key] != want:
            raise NotImplementedError(f"the reference computes {key}={want!r}, "
                                      f"the configuration states {conf[key]!r}")
    if conf["align"] not in ("zero", "center"):
        raise NotImplementedError(f"align {conf['align']!r}")


def axis_taps(n_in: int, n_out: int, a: int, align: str, normalize: bool):
    """``(index, weight)``, each ``(n_out, 2a)``: the input sample and the
    float64 weight of every tap of every output sample of one axis
    (upscales and equal sizes only: a downscale's stretched kernel is not
    defined here)."""
    if n_out < n_in:
        raise NotImplementedError("the reference upscales only")
    y = np.arange(n_out, dtype=np.int64)[:, None]
    # x = num / den exactly, in integers: den = 2·n_out
    num = 2 * y * n_in + (0 if align == "zero" else n_in - n_out)
    den = 2 * n_out
    floor_x = num // den
    i = floor_x + np.arange(-a + 1, a + 1, dtype=np.int64)[None, :]
    t = (num - i * den) / den
    w = np.sinc(t) * np.sinc(t / a)
    if normalize:
        w = w / w.sum(axis=1, keepdims=True)
    return np.clip(i, 0, n_in - 1), w


def exact(planes: torch.Tensor, conf: dict, out_shape) -> torch.Tensor:
    """The exact float64 value of every output sample of the uint8 planes
    ``(P, H, W)``, as ``(P, OH, OW)`` on their device, one plane at a
    time."""
    check_semantics(conf)
    dev = planes.device
    (h, w), (oh, ow) = planes.shape[-2:], out_shape
    taps = []
    for n_in, n_out in ((h, oh), (w, ow)):
        idx, wt = axis_taps(n_in, n_out, conf["a"], conf["align"], conf["normalize"])
        taps.append((torch.from_numpy(idx).to(dev), torch.from_numpy(wt).to(dev)))
    (iv, wv), (ih, wh) = taps
    out = torch.empty((planes.shape[0], oh, ow), dtype=torch.float64, device=dev)
    for p in range(planes.shape[0]):
        x = planes[p].to(torch.float64)
        v = torch.zeros((oh, w), dtype=torch.float64, device=dev)
        for j in range(iv.shape[1]):
            v += wv[:, j, None] * x[iv[:, j]]
        acc = out[p]
        acc.zero_()
        for j in range(ih.shape[1]):
            acc += wh[None, :, j] * v[:, ih[:, j]]
    return out


def gap_lsb(got: torch.Tensor, r: torch.Tensor) -> float:
    """The widest distance, in steps of one output level, by which the exact
    value ``r`` lies outside the interval that the uint8 output ``got``
    stands for: ``[y, y + 1)``, open below for 0 and above for 255.  Zero
    where every byte is ``trunc(clip(r, 0, 255))``."""
    y = got.to(torch.float64)
    lo = torch.where(got == 0, torch.full_like(y, -np.inf), y)
    hi = torch.where(got == 255, torch.full_like(y, np.inf), y + 1)
    return float(torch.maximum(lo - r, r - hi).clamp_min_(0).max())
