"""Resampling filter kernels (weight-generating functions).

The reference generates weights with a windowed sinc
``L(x) = a/π² · sinpi(x)·sinpi(x/a)/x²`` (``kernel.cpp:12-18``), which is
algebraically ``sinc(x)·sinc(x/a)`` with the normalized sinc.  Its fp64
oracle uses the same function via unnormalized sinc (``full_TB.h:51-53``).
We compute weights host-side in float64 NumPy (they are tiny — N phases ×
2a taps) and ship them to the device as a table, so filter evaluation is
never on the hot path.

A small registry adds the common production alternatives (triangle,
Mitchell-Netravali, Catmull-Rom, box) so the framework is a general
resampler, with Lanczos as the flagship.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

# A filter maps (t, a) -> weight, vectorized over t (float64 ndarray).
FilterFn = Callable[[np.ndarray, int], np.ndarray]

_REGISTRY: Dict[str, "Filter"] = {}


class Filter:
    """A named, fixed-support resampling kernel."""

    def __init__(self, name: str, fn: FilterFn):
        self.name = name
        self.fn = fn

    def __call__(self, t: np.ndarray, a: int) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        return np.where(np.abs(t) < a, self.fn(t, a), 0.0)


def register(name: str):
    def deco(fn: FilterFn) -> Filter:
        filt = Filter(name, fn)
        _REGISTRY[name] = filt
        return filt

    return deco


def get_filter(name: str) -> Filter:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown filter {name!r}; have {sorted(_REGISTRY)}")


@register("lanczos")
def lanczos(t: np.ndarray, a: int) -> np.ndarray:
    # np.sinc is the normalized sinc sin(pi x)/(pi x) — exactly the oracle's
    # sinc(M_PI*x)*sinc(M_PI*x/a) (full_TB.h:51-53).
    return np.sinc(t) * np.sinc(t / a)


@register("triangle")
def triangle(t: np.ndarray, a: int) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(t) / a)


@register("box")
def box(t: np.ndarray, a: int) -> np.ndarray:
    return np.where(np.abs(t) <= 0.5, 1.0, 0.0)


def _mitchell_family(t: np.ndarray, b: float, c: float) -> np.ndarray:
    x = np.abs(t)
    x2, x3 = x * x, x * x * x
    near = (12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)
    far = (-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x + (
        8 * b + 24 * c
    )
    out = np.where(x < 1, near, np.where(x < 2, far, 0.0))
    return out / 6.0


@register("mitchell")
def mitchell(t: np.ndarray, a: int) -> np.ndarray:
    del a  # fixed support 2
    return _mitchell_family(t, 1.0 / 3.0, 1.0 / 3.0)


@register("catmull_rom")
def catmull_rom(t: np.ndarray, a: int) -> np.ndarray:
    del a  # fixed support 2
    return _mitchell_family(t, 0.0, 0.5)


def available_filters():
    return sorted(_REGISTRY)
