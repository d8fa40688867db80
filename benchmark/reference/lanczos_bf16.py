"""The plain reference of the 16-bit path: a separable Lanczos upscale with
bf16 weights and a bf16 intermediate, written from the configuration file's
``guarantee`` alone.

It imports nothing of the program.  The contract, step by step:

(a) weights: :func:`lanczos.axis_taps`' normalized Lanczos-``a`` weights of
    each output sample (zero alignment, ``np.sinc(t)·np.sinc(t/a)`` where
    ``|t| < a`` and 0 elsewhere, float64); taps that the clamp puts on one
    input sample are summed, in tap order, into one weight;
(b) rounding the weights: each output's weights are rounded to bf16 as
    ``torch`` converts float64 (nearest-even to float32, then nearest-even
    to bf16); the float64 sum of its weights less the float64 sum of the
    rounded ones is added to the rounded weight of largest magnitude (of two
    equal, the one on the lower input sample), which is rounded again the
    same way;
(c) vertical pass first: each intermediate ``Σ wᵢ·xᵢ`` is rounded to bf16,
    nearest-even;
(d) horizontal pass over the bf16 weights and intermediates; each output
    byte is ``trunc(clip(r, 0, 255))``.

The program sums in fp32, in an order that is not part of the contract, so
a sum is known only to within a bound of its rounding error (:func:`bound`:
0 where every order sums exactly, as at the 2/1 half phase).  An
intermediate whose exact value lies within that bound of a bf16 rounding
boundary may round either way: both roundings are admitted there, and only
there, and the output's interval spans what each admitted intermediate
gives.  The horizontal sum's own error is left to the configuration's limit,
as ``lanczos.py`` leaves the fp32 sums': at most ``6·2⁻²⁴·Σ|wⱼ·mⱼ|``, about
1.3e-4 of an output level.  Widened by it, the interval would admit two
bytes at every output that lies on a whole number, and at the 2/1 plan
nearly half do: an output at a whole input column is its bf16
intermediate, plus taps of about 1e-17 where ``np.sinc`` meets a whole
number.

:func:`exact` returns, for every output sample, the interval ``[lo, hi]``
of the values that the contract admits, as one ``complex128`` tensor of the
outputs' shape: ``lo`` the real part, ``hi`` the imaginary part.
:func:`gap_lsb` measures a uint8 output against it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.lanczos import axis_taps

SUPPORTED = dict(precision="bf16", filter="lanczos", edge_mode="clamp", align="zero",
                 order="height_first", normalize=True, dering=False,
                 intermediate_quantize=False)
# float64 significand bits below bf16's seven
DROP = 52 - 7
# the unit roundoff of an fp32 sum: each of its additions errs by at most
# this share of its result
U32 = 2.0 ** -24


def check_semantics(conf: dict) -> None:
    """Raise where the configuration asks for what this reference does not
    compute."""
    for key, want in SUPPORTED.items():
        if conf[key] != want:
            raise NotImplementedError(f"the reference computes {key}={want!r}, "
                                      f"the configuration states {conf[key]!r}")
    if any(o < i for i, o in zip(conf["in_shape"], conf["out_shape"])):
        raise NotImplementedError("the reference upscales only")


def round_bf16(v: torch.Tensor) -> torch.Tensor:
    """Each float64 value rounded once to the nearest bf16 (8 significant
    bits), ties to even, as float64: on the bits, add just under half of
    the dropped part, plus its last kept bit, and cut the dropped part (a
    carry runs into the exponent as it should; the sign bit is untouched,
    the magnitude is rounded)."""
    b = v.contiguous().view(torch.int64)
    b = b + ((1 << (DROP - 1)) - 1) + ((b >> DROP) & 1)
    return (b & ~((1 << DROP) - 1)).view(torch.float64)


def rounded_taps(n_in: int, n_out: int, conf: dict):
    """``(index, weight)``, each ``(n_out, 2a)``: steps (a) and (b) for one
    axis.  A clamped tap that repeats the sample of the tap before it has
    its weight moved there (summed in tap order) and keeps weight 0."""
    idx, w = axis_taps(n_in, n_out, conf["a"], conf["align"], False)
    # Lanczos is 0 at |t| ≥ a: where x is whole, the last tap lies a samples
    # away, at t = −a, where np.sinc leaves about 1e-33
    rows = np.arange(n_out)[:, None]
    w[(2 * rows[:, 0] * n_in) % (2 * n_out) == 0, -1] = 0.0
    if conf["normalize"]:
        w = w / w.sum(axis=1, keepdims=True)
    slot = np.tile(np.arange(idx.shape[1]), (n_out, 1))
    for j in range(1, idx.shape[1]):
        same = idx[:, j] == idx[:, j - 1]
        slot[same, j] = slot[same, j - 1]
    folded = np.zeros_like(w)
    np.add.at(folded, (np.broadcast_to(rows, idx.shape), slot), w)
    t = torch.from_numpy(folded)

    def to_bf16(x):  # as torch converts float64: through float32
        return round_bf16(x.to(torch.float32).double())

    r = to_bf16(t)
    resid = t.sum(1) - r.sum(1)
    top = r.abs().argmax(1)  # the first of equals: the lower input sample
    r[torch.arange(n_out), top] = to_bf16(r[torch.arange(n_out), top] + resid)
    return idx, r.numpy()


def bound(s: torch.Tensor, n: int, grid: torch.Tensor) -> torch.Tensor:
    """How far an fp32 sum of ``n`` terms can lie from the exact sum, where
    ``s`` is the sum of the terms' magnitudes, each term is exact in fp32 (a
    bf16 weight times a byte: 16 significant bits) and a whole multiple of
    ``grid``.

    Where ``s ≤ 2²⁴·grid``, every partial sum, in any order, is a multiple
    of ``grid`` of at most ``2²⁴`` steps, which fp32 holds: the sum is
    exact, and the bound 0.  Elsewhere the sum makes at most ``n − 1``
    roundings, each of at most ``U32`` times the partial sum it rounds, and
    a partial sum is at most ``s`` plus the errors before it: the error
    ``e`` obeys ``e ≤ (n − 1)·U32·(s + e)``, so ``e ≤ (n − 1)·U32·s /
    (1 − (n − 1)·U32)``, which is below ``n·U32·s`` wherever
    ``n·(n − 1)·U32 ≤ 1``.  What is left over, about ``U32·s``, covers the
    float64 arithmetic that computes the exact sum here (``n·2⁻⁵³·s``)."""
    return torch.where(s <= 2.0 ** 24 * grid, 0.0, n * U32 * s)


def grid_of(w: np.ndarray) -> np.ndarray:
    """``(n_out, 1)``: the step of which every product of a row's bf16
    weights with a whole number is a multiple, ``2^(e − 8)`` for the least
    exponent ``e`` (``w = f·2^e``, ``½ ≤ |f| < 1``) of its nonzero weights:
    a bf16 weight is a whole number of such steps, under 2⁸."""
    _, e = np.frexp(w)
    e = np.where(w != 0, e, np.iinfo(e.dtype).max).min(1, keepdims=True)
    return np.ldexp(1.0, e - 8)


def exact(planes: torch.Tensor, conf: dict, out_shape) -> torch.Tensor:
    """The interval ``[lo, hi]`` of every output sample of the uint8 planes
    ``(P, H, W)`` that the contract admits, as ``lo + 1j·hi``, a
    ``(P, OH, OW)`` complex128 tensor on their device, one plane at a
    time."""
    check_semantics(conf)
    dev = planes.device
    (h, w), (oh, ow) = planes.shape[-2:], out_shape
    (iv, wv), (ih, wh) = rounded_taps(h, oh, conf), rounded_taps(w, ow, conf)
    grid = grid_of(wv)
    iv, wv, grid, ih, wh = (torch.from_numpy(t).to(dev) for t in (iv, wv, grid, ih, wh))
    n = 2 * conf["a"]
    out = torch.empty((planes.shape[0], oh, ow), dtype=torch.complex128, device=dev)
    for p in range(planes.shape[0]):
        x = planes[p].to(torch.float64)
        v = torch.zeros((oh, w), dtype=torch.float64, device=dev)
        s = torch.zeros_like(v)
        for j in range(n):
            v += wv[:, j, None] * x[iv[:, j]]
            s += wv[:, j, None].abs() * x[iv[:, j]]
        d = bound(s, n, grid)
        m_lo, m_hi = round_bf16(v - d), round_bf16(v + d)
        del v, s, d
        lo = torch.zeros((oh, ow), dtype=torch.float64, device=dev)
        hi = torch.zeros_like(lo)
        for j in range(n):
            c = wh[None, :, j]
            a, b = m_lo[:, ih[:, j]], m_hi[:, ih[:, j]]
            lo += torch.where(c >= 0, c * a, c * b)
            hi += torch.where(c >= 0, c * b, c * a)
        del m_lo, m_hi
        out[p] = torch.complex(lo, hi)
    return out


def gap_lsb(got: torch.Tensor, r: torch.Tensor) -> float:
    """The widest distance, in steps of one output level, between the
    interval that the uint8 output ``got`` stands for, ``[y, y + 1)`` (open
    below for 0 and above for 255), and the admitted interval ``[lo, hi]``
    of :func:`exact`'s ``r``.  Zero where every byte is one that the
    contract admits."""
    y = got.to(torch.float64)
    y_lo = torch.where(got == 0, torch.full_like(y, -np.inf), y)
    y_hi = torch.where(got == 255, torch.full_like(y, np.inf), y + 1)
    return float(torch.maximum(y_lo - r.imag, r.real - y_hi).clamp_min_(0).max())
