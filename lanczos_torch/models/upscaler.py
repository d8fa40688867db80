"""High-level upscaler (the port of ``lanczos_tpu/models/upscaler.py``).

An :class:`Upscaler` owns one static :class:`ResampleConfig`, a backend
choice and that backend's tables on each device it has run on.  Backends,
with the JAX package's names:

- ``"cuda"``: the port's hand-written CUDA kernels, routed by
  ``ops/resample_cuda.FusedOps`` as the JAX package's ``auto`` routes its
  Pallas kernels: the fused kernel for every uint8 ``precise``-family
  config with a fused plan (linear, dering, quantized intermediate, either
  pass order), kernel 2 for integer-scale dering without one;
- ``"pallas"``: as ``PallasOps(variant="auto")`` on a TPU: the fused
  kernel where a plan fits, else kernel 2 for any integer config, else v1
  (``ops/resample_phase_cuda``);
- ``"shift_xla"``: strided shift-FMA tensor ops (``ops/resample_strided``;
  needs N ≤ 32 phases and D-divisible input dims);
- ``"block"``: blocked banded products (``ops/resample_block``), any
  linear config;
- ``"xla"``: per-tap gathers (``ops/resample_gather``), the portable
  reference path, also differentiable;
- ``"c_exact"``: the bit-exact int64 emulation of the C oracle
  (``ops/c_exact``), what ``profile="c_oracle"`` runs;
- ``"ref"``: the host NumPy oracles (``lanczos_torch.ref``), for testing.

``"auto"`` takes ``"cuda"`` wherever ``FusedOps`` takes the config, else
falls through strided → block → gather as the JAX ``auto`` does; the
``hls`` profile runs the fixed-point path (``ops/fixed_point``) whatever
the backend but ``"ref"``.

The dtype contract: uint8 → uint8; uint16 → uint16 through the float path
and ``trunc(clip(·, 0, 65535))``; float → float, linear and unclipped.
The kernels are uint8 → uint8, so other input on ``"cuda"``/``"pallas"``
takes the strided path where it is eligible, else block.

A torch tensor runs on its own device: on CUDA through the kernels and the
tensor ops on the card, on the CPU through the kernels' plain versions
and the same tensor ops.  A numpy array goes to the ``device`` the
upscaler was made for, ``"cuda"`` by default, and that raises where CUDA
is absent: the port never falls back to the CPU.  Only ``"ref"`` computes
on the host, and returns on the input's device.
"""

from __future__ import annotations

import collections
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from lanczos_torch.core.config import (
    EdgeMode,
    Order,
    Precision,
    Profile,
    ResampleConfig,
)
from lanczos_torch.ops.c_exact import CExactOps
from lanczos_torch.ops.fixed_point import HLSOps, hls_upscale
from lanczos_torch.ops.resample_block import BlockOps, resample_2d_block
from lanczos_torch.ops.resample_cuda import (
    FusedOps,
    pallas_variant,
    resample_2d_cuda,
    upscale_planar,
)
from lanczos_torch.ops.resample_gather import SeparableOps, resample_2d_gather
from lanczos_torch.ops.resample_strided import (
    MAX_PHASES,
    StridedOps,
    resample_2d_strided,
)

BACKENDS = ("auto", "cuda", "pallas", "shift_xla", "block", "xla", "c_exact", "ref")


def _shift_eligible(cfg: ResampleConfig) -> bool:
    """Whether the strided shift-FMA path covers this config: float
    precision, no c-faithful quirk, phase counts within the unroll budget,
    and D-divisible input dims."""
    if cfg.precision == Precision.FIXED or cfg.c_faithful:
        return False
    if cfg.intermediate_quantize:
        return False
    if cfg.edge_mode == EdgeMode.DROP and (cfg.normalize or cfg.dering):
        # drop-edge + normalization renormalizes over the surviving taps
        # per row, and drop-edge dering clamps against edge-clamped tap
        # VALUES — neither is expressible as zero padding + phase-uniform
        # weights
        return False
    if cfg.order == Order.WIDTH_FIRST and cfg.dering:
        # the shift path is height-first; with the (nonlinear) dering
        # clamp the pass order is observable — keep the gather path
        return False
    (nv, dv), (nh, dh) = cfg.scale_h, cfg.scale_w
    if nv > MAX_PHASES or nh > MAX_PHASES:
        return False
    return cfg.in_shape[0] % dv == 0 and cfg.in_shape[1] % dh == 0


def _block_eligible(cfg: ResampleConfig) -> bool:
    """Whether the blocked banded-product path covers this config: any
    *linear* float config (edge modes, drop+normalize, dering-on-top,
    arbitrary N/D), i.e. everything but the fixed-point and c-faithful
    semantics."""
    return cfg.precision != Precision.FIXED and not cfg.c_faithful


def _cuda_auto_eligible(cfg: ResampleConfig) -> bool:
    """Whether ``auto`` runs the port's CUDA kernels: ``FusedOps`` takes
    the config (a fused plan fits, or kernel 2 takes integer-scale
    dering), the counterpart of the JAX ``_pallas_auto_eligible``."""
    if cfg.precision == Precision.FIXED or cfg.c_faithful:
        return False
    try:
        FusedOps(cfg, "cpu")
    except NotImplementedError:
        return False
    return True


def _auto_backend(cfg: ResampleConfig) -> str:
    """The backend ``"auto"`` resolves to (the JAX ``Upscaler``'s chain,
    with the CUDA kernels first)."""
    if _cuda_auto_eligible(cfg):
        return "cuda"
    if _shift_eligible(cfg):
        return "shift_xla"
    if _block_eligible(cfg):
        return "block"
    return "xla"


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
    def __init__(self, cfg: ResampleConfig, backend: str = "auto", device="cuda",
                 dtype=torch.float32):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if cfg.precision == Precision.BF16 else dtype
        if backend == "auto":
            backend = _auto_backend(cfg)
        self.backend = backend
        # which ops run: the backend's, or the bit-exact profiles' own
        if backend == "ref":
            self.path = "ref"
        elif cfg.c_faithful and backend in ("xla", "c_exact"):
            # bit-exact integer-lattice emulation of the reference's fp64
            # sequential arithmetic; an fp32 gather CANNOT reproduce the
            # oracle's truncations for a != 2
            self.backend = self.path = "c_exact"
        elif cfg.precision == Precision.FIXED:
            self.path = "hls"
        elif backend == "c_exact":
            raise ValueError("backend 'c_exact' needs a c_faithful config (profile='c_oracle')")
        else:
            self.path = "cuda" if backend in ("cuda", "pallas") else backend
        self.variant = (
            pallas_variant(cfg) if backend == "pallas" and self.path == "cuda" else "auto"
        )
        self._ops: dict = {}
        self._fallback: dict = {}
        self._lock = threading.Lock()
        # build on the host now: raises where the JAX package's ops raise
        cpu = self._ops_for(torch.device("cpu"))
        self.plan = cpu.plan if self.path == "cuda" else None

    def _make(self, device: torch.device):
        cfg = self.cfg
        if self.path == "cuda":
            plan = self._ops[torch.device("cpu")].plan if self._ops else None
            return FusedOps(cfg, device, plan, self.variant)
        if self.path == "shift_xla":
            return StridedOps(cfg, self.dtype, device)
        if self.path == "block":
            return BlockOps(cfg, self.dtype, device=device)
        if self.path == "xla":
            return SeparableOps(cfg, self.dtype, device)
        if self.path == "c_exact":
            return CExactOps(cfg, device)
        if self.path == "hls":
            return HLSOps.build(cfg, device=device)
        return None  # ref: the host oracles need no tables

    def _ops_for(self, device: torch.device):
        with self._lock:
            if device not in self._ops:
                self._ops[device] = self._make(device)
            return self._ops[device]

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        if self.path == "ref":
            return self._ref_forward(x)
        ops = self._ops_for(x.device)
        if self.path == "cuda":
            return resample_2d_cuda(x, ops)
        if self.path == "shift_xla":
            return resample_2d_strided(x, ops)
        if self.path == "block":
            return resample_2d_block(x, ops)
        if self.path == "xla":
            return resample_2d_gather(x, ops)
        if self.path == "hls":
            return hls_upscale(x, ops)
        return ops(x)  # c_exact

    def _float_fallback(self, x: torch.Tensor) -> torch.Tensor:
        """Non-uint8 input on the kernel backends: strided where eligible,
        else block (the JAX ``_float_fallback_fn``)."""
        with self._lock:
            ops = self._fallback.get(x.device)
            if ops is None:
                ops = self._fallback[x.device] = (
                    StridedOps(self.cfg, self.dtype, x.device)
                    if _shift_eligible(self.cfg)
                    else BlockOps(self.cfg, self.dtype, device=x.device)
                )
        if isinstance(ops, StridedOps):
            return resample_2d_strided(x, ops)
        return resample_2d_block(x, ops)

    def _ref_forward(self, x: torch.Tensor) -> torch.Tensor:
        from lanczos_torch.ref.oracle import c_oracle_upscale, clean_resample_2d

        img = x.detach().cpu().numpy()

        def one(im):
            oh, ow = self.cfg.out_shape
            if self.cfg.precision == Precision.FIXED:
                from lanczos_torch.ref.hls_sim import hls_stream_upscale

                return hls_stream_upscale(im, oh, ow, self.cfg.a, self.cfg.bit_precision)
            if self.cfg.c_faithful:
                return c_oracle_upscale(im, oh, ow, self.cfg.a)
            return clean_resample_2d(im, self.cfg)

        if img.ndim > 3:  # (..., H, W, C): the oracles are single-image — loop
            lead = img.shape[:-3]
            outs = np.stack([one(f) for f in img.reshape((-1,) + img.shape[-3:])])
            out = outs.reshape(lead + outs.shape[1:])
        else:
            out = one(img)
        return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)

    def __call__(self, img) -> torch.Tensor:
        """img: (H, W, C) or (..., H, W, C); dims must match the config.
        Returns (..., OH, OW, C) on the input's device (a numpy input: on
        the upscaler's device).

        dtype contract: uint8 → uint8 (the reference's trunc-clip byte
        cast); uint16 (e.g. from ``io.decode_image_16``) → uint16 via the
        same semantics at 16-bit width; float → float, linear and
        unclipped."""
        if tuple(img.shape[-3:-1]) != tuple(self.cfg.in_shape):
            raise ValueError(
                f"image spatial dims {tuple(img.shape[-3:-1])} != config "
                f"{self.cfg.in_shape}"
            )
        x = _as_tensor(img, self.device)
        kernels = self.path == "cuda"
        if x.dtype == torch.uint16:
            # the backends' integer path quantizes to the uint8 range (the
            # reference's clamp_to_byte); at 16-bit width run the float
            # path and apply the same trunc-clip against 65535
            if self.cfg.precision == Precision.FIXED or self.cfg.c_faithful:
                raise ValueError(
                    "uint16 input is not defined for the bit-exact uint8 "
                    "semantics profiles (hls/c_oracle); convert explicitly"
                )
            xf = x.to(torch.float32)
            y = self._float_fallback(xf) if kernels else self._run(xf)
            return torch.trunc(torch.clamp(y.float(), 0.0, 65535.0)).to(torch.uint16)
        if kernels and x.dtype != torch.uint8:
            # the kernels are uint8 → uint8 by design; quantizing a float
            # input would silently break the float-in/float-out contract
            return self._float_fallback(x)
        return self._run(x)

    def planar(self, img) -> torch.Tensor:
        """Planar path: (C, H, W) or (B, C, H, W) → same rank, without the
        interleaved↔planar transposes on the kernel and strided backends
        (uint8); every other case goes through :meth:`__call__`."""
        if tuple(img.shape[-2:]) != tuple(self.cfg.in_shape):
            raise ValueError(
                f"image spatial dims {tuple(img.shape[-2:])} != config "
                f"{self.cfg.in_shape}"
            )
        x = _as_tensor(img, self.device)
        if x.dtype == torch.uint8 and self.path == "cuda":
            return upscale_planar(x, self._ops_for(x.device))
        if x.dtype == torch.uint8 and self.path == "shift_xla":
            return resample_2d_strided(x, self._ops_for(x.device), channel_last=False)
        return self(x.movedim(-3, -1)).movedim(-1, -3)


def _device_table_bytes(model: Upscaler) -> int:
    """Bytes of the weight and index tables an Upscaler holds: every numpy
    array and tensor reachable from its ops (host plans and every device
    copy)."""
    seen: set[int] = set()
    total = 0
    stack: list = [model._ops, model._fallback]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif isinstance(obj, np.ndarray):
            total += obj.nbytes
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif type(obj).__module__.startswith("lanczos_torch") and hasattr(obj, "__dict__"):
            stack.extend(vars(obj).values())
    return total


class _UpscalerCache:
    """(cfg, backend, device) → :class:`Upscaler`, LRU-evicted by total
    weight-table bytes as well as entry count.

    Caching spares the tables' construction on every call, but each entry
    pins its tables on the host and on the card, so a long-lived process
    cycling configs must not keep them all.  ResampleConfig is a frozen
    dataclass, so it is its own key.  The newest entry always survives even
    if it alone exceeds ``max_bytes``.  Sizes are taken when an entry is
    made, before its first call uploads the device tables, so they count
    the host tables only."""

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
    mesh=None,
    **overrides,
) -> torch.Tensor:
    """One-shot functional API: upscale (…, H, W, C) by N/D or to out_shape.

    A bare 2-D (H, W) image is treated as single-channel grayscale and
    returned 2-D.  A torch tensor runs on its own device; a numpy array on
    ``device``.  Repeat calls with the same (config, backend, device) reuse
    one :class:`Upscaler`.  ``mesh`` (row and batch sharding) is the
    multi-device slice, not ported yet (ROADMAP queue 1, item 9)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (row and batch sharding) comes with the multi-device "
            "slice (ROADMAP queue 1, item 9)"
        )
    gray2d = getattr(img, "ndim", 0) == 2
    if gray2d:
        img = img[..., None]
    h, w = img.shape[-3], img.shape[-2]
    cfg = ResampleConfig.from_profile(
        profile, (h, w), out_shape=out_shape, scale=scale, a=a, **overrides
    )
    out = _cached_upscaler(cfg, backend, device)(img)
    return out[..., 0] if gray2d else out
