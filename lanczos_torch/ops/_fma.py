"""One rounding a tap: the plain versions' sums as the card's ``fmaf``.

Every kernel of the port sums its taps with fused multiply-adds, each tap
``acc = fmaf(w, x, acc)``: the exact ``acc + w·x`` rounded once to fp32.
The JAX package's tap chains come out the same way on the CPU, where XLA
contracts them into FMAs.  A multiply and then an add rounds twice, and on
a constant plane that puts the sum a few ulps below the exact value, which
the output's truncation turns into a whole level.

:func:`fma_sum` gives ``fmaf``'s chain with tensor ops.  The product of two
fp32 values is exact in float64, and the float64 sum ``s`` rounded to fp32
is the single rounding except where ``s`` was itself rounded onto an fp32
rounding boundary: a midpoint between two fp32 values (its low 29 mantissa
bits ``1 0…0``), or anywhere below fp32's normal range (2^-126), where
fewer bits are kept.  Each tap flags the midpoints (two integer ops; the
exact ones among them, about one sum in 256, need nothing but cost
nothing either); the second case cannot arise where every product is zero
or at least 2^-126 (a partial sum below 2^-126 is then exact in float64),
which the weights' and the source's smallest magnitudes decide once a
sum, and is flagged a tap where it can.  A flagged sum is redone exactly:
rounded to odd (an inexact sum whose last mantissa bit is even steps one
ulp toward the exact value, found by TwoSum's error term), then to
nearest fp32.  53 ≥ 2·24 + 2, so the two roundings give the single one
(Boldo & Melquiond, "Emulation of FMA and correctly rounded sums: proved
algorithms using rounding to odd", IEEE Trans. Computers 57(4), 2008).
Gradients flow through the float64 sums; a redone sum's one-ulp step is a
constant to them.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

Weight = Union[torch.Tensor, float]

_LOW29 = (1 << 29) - 1  # the float64 mantissa bits an fp32 drops
_MIDPOINT = 1 << 28  # ... holding exactly half an fp32 ulp
_TINY = 2.0**-126  # fp32's smallest normal magnitude


def _round_to_odd(a: torch.Tensor, w, x: torch.Tensor) -> torch.Tensor:
    """The exact ``a + w·x`` (float64 operands) rounded to odd in float64."""
    p = x * w
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)  # TwoSum: s + err == a + p exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def fma_tap(acc: Optional[torch.Tensor], w: Weight, x: torch.Tensor) -> torch.Tensor:
    """``acc + w·x`` rounded once, as ``fmaf(w, x, acc)``, exactly for any
    fp32 operands; ``acc`` None is the first tap, the rounded product
    (``fmaf(w, x, 0)``).  ``w`` is an fp32 tensor or a Python float that
    fp32 holds exactly; ``x`` fp32 (or float64 holding fp32 values)."""
    if acc is None:
        return (w * x).float()
    w64 = w.double() if isinstance(w, torch.Tensor) else w
    return _round_to_odd(acc.double(), w64, x.double()).float()


def _as64(w: Weight, device) -> torch.Tensor:
    return (w.double() if isinstance(w, torch.Tensor)
            else torch.tensor(w, dtype=torch.float64, device=device))


def _smallest(v) -> float:
    """The smallest nonzero magnitude in ``v`` (inf if none)."""
    a = torch.as_tensor(v).detach().abs()
    a = a[a > 0]
    return float(a.min()) if a.numel() else float("inf")




def fma_sum(term: Callable[[int], tuple], taps: int, source: torch.Tensor,
            weights) -> torch.Tensor:
    """``Σ_t w_t·x_t`` in tap order, each tap rounded once as ``fmaf``.

    ``term(t)`` gives tap ``t``'s ``(w_t, x_t)``: a weight from ``weights``
    (a tensor that broadcasts against ``x_t``, or a Python float) and
    ``x_t`` gathered from ``source`` (or from a float64 copy of it, which
    saves a conversion a tap).  An fp32 ``source`` takes fp32 weights and
    the single rounding; any other dtype sums with its own multiply and
    add."""
    w, x = term(0)
    if source.dtype != torch.float32:
        acc = w * x
        for t in range(1, taps):
            w, x = term(t)
            acc = acc + w * x
        return acc
    acc = (w * x).float()
    # where every product is zero or at least 2^-126, a partial sum below fp32's
    # normal range is exact in float64 and needs no care
    tiny_products = _smallest(weights) * _smallest(source) < _TINY
    for t in range(1, taps):
        w, x = term(t)
        w64 = _as64(w, x.device)
        s = torch.addcmul(acc, x.double(), w64)  # promoted: float64 throughout
        with torch.no_grad():
            near = (s.view(torch.int64) & _LOW29).eq_(_MIDPOINT)
            if tiny_products:
                near |= (s != 0) & (s.abs() < _TINY)
            redo = bool(near.any())
        acc = _redo(s.float(), acc, w64, x, near) if redo else s.float()
    return acc


def _redo(new: torch.Tensor, acc: torch.Tensor, w64: torch.Tensor, x: torch.Tensor,
          near: torch.Tensor) -> torch.Tensor:
    """``new`` (``acc + w·x`` through float64) with its ``near`` elements
    taken again by :func:`fma_tap`."""
    with torch.no_grad():
        idx = near.nonzero(as_tuple=True)
        aa, ww, xx = (v.detach().expand(new.shape)[idx] for v in (acc, w64, x))
        exact = fma_tap(aa, ww.float(), xx)
        if not new.requires_grad:
            return new.index_put_(idx, exact)
        step = torch.zeros_like(new).index_put_(idx, exact - new.detach()[idx])
    return new + step


_PART = 1 << 15  # outputs of one part: PyTorch's grain, below which a CPU op runs on one thread


def by_parts(x: torch.Tensor, axis: int, out_len: int, fn: Callable) -> torch.Tensor:
    """``fn(x)`` for a pass along ``axis`` that gives ``out_len`` outputs
    there; on the CPU, over parts of ``x`` cut along its longest other axis
    so that each part has at most :data:`_PART` outputs, joined again.

    A sum of one rounding a tap is a few tensor ops a tap.  Below the grain
    each op runs on one thread over data that stays in cache, where a whole
    pass would start every op's thread team afresh, and where several
    processes share the cores (a test run's workers) those teams wait on
    each other.  On a CUDA tensor ``fn`` sees the whole of ``x``."""
    axis %= x.dim()
    outputs = x.numel() // max(x.shape[axis], 1) * out_len
    parts = -(-outputs // _PART)
    others = [d for d in range(x.dim()) if d != axis]
    if x.device.type != "cpu" or parts <= 1 or not others:
        return fn(x)
    k = max(others, key=lambda d: x.shape[d])
    size = x.shape[k]
    step = max(1, -(-size // parts))
    return torch.cat([fn(x.narrow(k, lo, min(step, size - lo))) for lo in range(0, size, step)],
                     dim=k)


def gather_sum(x: torch.Tensor, axis: int, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[o] = Σ_t w[o, t] · x[rows[o, t]]`` along ``axis``, in tap order,
    each tap rounded once (:func:`fma_sum`; a float64 ``x`` keeps its own
    multiply and add), on the CPU in parts (:func:`by_parts`).  ``rows``
    (out, T) int64 and ``w`` (out, T) on ``x``'s device."""
    shape = [1] * x.dim()
    shape[axis] = rows.shape[0]

    def pass_(part):
        src = part.double() if part.dtype == torch.float32 else part  # once, not a tap
        return fma_sum(lambda t: (w[:, t].reshape(shape), src.index_select(axis, rows[:, t])),
                       rows.shape[1], part, w)

    return by_parts(x, axis, rows.shape[0], pass_)
