"""High-level upscaler (the port of ``lanczos_tpu/models/upscaler.py``).

An :class:`Upscaler` owns one static :class:`ResampleConfig`, its plan
and the plan's tables on each device it has run on.  The port's backends
are its hand-written CUDA kernels, routed by ``ops/resample_cuda.FusedOps``:

- ``"cuda"`` (what ``"auto"`` picks) as the JAX package's ``auto`` routes
  its Pallas kernels: the fused kernel for every uint8 ``precise``-family
  config with a fused plan, linear, with the dering clamp or with the
  quantized intermediate, either pass order; kernel 2 for integer-scale
  dering without one;
- ``"pallas"`` as ``PallasOps(variant="auto")`` on a TPU: the fused
  kernel where a plan fits, else kernel 2 for any integer config, else
  v1 (``ops/resample_phase_cuda``), e.g. for a steep rational downscale.

Every other config raises ``NotImplementedError`` naming the slice of the
port that will bring it.

A torch tensor runs on its own device: on CUDA through the kernel, on the
CPU through the kernel's plain PyTorch version.  A numpy array goes to the
``device`` the upscaler was made for, ``"cuda"`` by default, and that
raises where CUDA is absent: the port never falls back to the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from lanczos_torch.core.config import Profile, ResampleConfig
from lanczos_torch.ops.resample_cuda import (
    FusedOps,
    pallas_variant,
    resample_2d_cuda,
    upscale_planar,
)


def _as_tensor(img, device: torch.device) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass a CPU tensor, or device='cpu', to "
            "run the plain PyTorch version"
        )
    return torch.as_tensor(np.ascontiguousarray(img), device=device)


class Upscaler:
    def __init__(self, cfg: ResampleConfig, backend: str = "auto", device="cuda"):
        if backend not in ("auto", "cuda", "pallas"):
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet: the port has its "
                "CUDA kernels ('cuda', and 'pallas' as the JAX package routes "
                "its Pallas kernels); the gather, shift and block paths are "
                "ROADMAP queue 1, items 3 and 5"
            )
        self.cfg = cfg
        self.backend = "pallas" if backend == "pallas" else "cuda"
        self.variant = pallas_variant(cfg) if backend == "pallas" else "auto"
        self.device = torch.device(device)
        # raises NotImplementedError for configs the slice does not cover
        cpu = FusedOps(cfg, "cpu", variant=self.variant)
        self.plan = cpu.plan  # the fused plan; None where kernel 2 or v1 runs
        self._ops = {torch.device("cpu"): cpu}
        self._lock = threading.Lock()

    def _ops_for(self, device: torch.device) -> FusedOps:
        with self._lock:
            ops = self._ops.get(device)
            if ops is None:
                ops = self._ops[device] = FusedOps(
                    self.cfg, device, self.plan, self.variant
                )
            return ops

    def _check_dtype(self, x: torch.Tensor) -> None:
        if x.dtype != torch.uint8 and self.backend == "pallas":
            raise NotImplementedError(
                f"{x.dtype} input on backend 'pallas': the JAX package runs it "
                "on its shift and block paths (ROADMAP queue 1, items 3 and "
                "5); the kernels are uint8 -> uint8"
            )
        if x.dtype != torch.uint8:
            raise NotImplementedError(
                f"{x.dtype} input: the float and uint16 contract comes with "
                "the gather path (ROADMAP queue 1, item 3); the fused kernel "
                "is uint8 -> uint8"
            )

    def __call__(self, img) -> torch.Tensor:
        """img: (H, W, C) or (..., H, W, C) uint8; dims must match the
        config.  Returns uint8 of shape (..., OH, OW, C) on the input's
        device (a numpy input: on the upscaler's device), as a
        channels-last view of the planar result where the shape allows."""
        if tuple(img.shape[-3:-1]) != tuple(self.cfg.in_shape):
            raise ValueError(
                f"image spatial dims {tuple(img.shape[-3:-1])} != config "
                f"{self.cfg.in_shape}"
            )
        x = _as_tensor(img, self.device)
        self._check_dtype(x)
        return resample_2d_cuda(x, self._ops_for(x.device))

    def planar(self, img) -> torch.Tensor:
        """Planar path: (C, H, W) or (B, C, H, W) uint8 → same rank,
        without the interleaved↔planar transposes."""
        if tuple(img.shape[-2:]) != tuple(self.cfg.in_shape):
            raise ValueError(
                f"image spatial dims {tuple(img.shape[-2:])} != config "
                f"{self.cfg.in_shape}"
            )
        x = _as_tensor(img, self.device)
        self._check_dtype(x)
        return upscale_planar(x, self._ops_for(x.device))


def _host_bytes(plan) -> int:
    """Bytes of the numpy arrays in a plan, its per-axis plans included."""
    return sum(
        v.nbytes if isinstance(v, np.ndarray)
        else _host_bytes(v) if dataclasses.is_dataclass(v) else 0
        for v in vars(plan).values()
    )


def _device_table_bytes(model: Upscaler) -> int:
    """Bytes of the weight tables an Upscaler holds: the host plan's
    arrays and every device copy of them."""
    cpu = model._ops[torch.device("cpu")]
    held = (o.plan for o in (cpu, cpu.shift, cpu.phase) if o is not None)
    plan = next(p for p in held if p is not None)
    total = _host_bytes(plan)
    for ops in model._ops.values():
        total += sum(t.numel() * t.element_size() for t in ops.table_tensors())
    return total


class _UpscalerCache:
    """(cfg, backend, device) → :class:`Upscaler`, LRU-evicted by total
    weight-table bytes as well as entry count.

    Caching spares the plan's construction on every call, but each entry
    pins its weight stacks on the host and on the card, so a long-lived
    process cycling configs must not keep them all.  ResampleConfig is a
    frozen dataclass, so it is its own key.  The newest entry always
    survives even if it alone exceeds ``max_bytes``.  Sizes are taken when
    an entry is made, before its first call uploads the device weights, so
    they count the host tables only."""

    def __init__(self, max_entries: int = 64, max_bytes: int = 256 << 20):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._data: "OrderedDict[tuple, tuple[Upscaler, int]]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()

    def __call__(self, cfg: ResampleConfig, backend: str, device) -> Upscaler:
        key = (cfg, backend, str(device))
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
                self._hits += 1
                return hit[0]
            self._misses += 1
        model = Upscaler(cfg, backend=backend, device=device)
        size = _device_table_bytes(model)
        with self._lock:
            race = self._data.get(key)
            if race is not None:  # another thread built it first
                self._data.move_to_end(key)
                return race[0]
            self._data[key] = (model, size)
            self._bytes += size
            while len(self._data) > 1 and (
                len(self._data) > self.max_entries
                or self._bytes > self.max_bytes
            ):
                _, (_, evicted) = self._data.popitem(last=False)
                self._bytes -= evicted
        return model

    def cache_clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0
            self._hits = self._misses = 0

    def cache_info(self):
        with self._lock:
            return _CacheInfo(
                self._hits, self._misses, self.max_entries,
                len(self._data), self._bytes,
            )


_CacheInfo = collections.namedtuple(
    "CacheInfo", ["hits", "misses", "maxsize", "currsize", "currbytes"]
)

_cached_upscaler = _UpscalerCache()


def upscale(
    img,
    scale: Optional[Tuple[int, int]] = None,
    out_shape: Optional[Tuple[int, int]] = None,
    profile: Profile | str = Profile.PRECISE,
    a: int = 3,
    backend: str = "auto",
    device="cuda",
    **overrides,
) -> torch.Tensor:
    """One-shot functional API: upscale (…, H, W, C) by N/D or to out_shape.

    A bare 2-D (H, W) image is treated as single-channel grayscale and
    returned 2-D.  A torch tensor runs on its own device; a numpy array on
    ``device``.  Repeat calls with the same (config, backend, device) reuse
    one :class:`Upscaler`."""
    gray2d = getattr(img, "ndim", 0) == 2
    if gray2d:
        img = img[..., None]
    h, w = img.shape[-3], img.shape[-2]
    cfg = ResampleConfig.from_profile(
        profile, (h, w), out_shape=out_shape, scale=scale, a=a, **overrides
    )
    out = _cached_upscaler(cfg, backend, device)(img)
    return out[..., 0] if gray2d else out
