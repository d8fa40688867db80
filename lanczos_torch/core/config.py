"""Resampling configuration.

Replaces the reference's compile-time ``params.h`` macro system
(reference ``lanczos.h:9-31``) and its three generations of gcd machinery
(``gcd.h``, ``util_includes/simp/``, ``stb.cpp:9-12``) with one runtime
dataclass.  The invariant kept from the reference: the scale is always an
**exact reduced rational** N/D (never a float), because the entire phase-LUT
weight scheme (reference ``kernel.cpp:50-59``) rests on ``out·D − in·N``
taking only N distinct values mod N.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from fractions import Fraction
from typing import Optional, Tuple


class EdgeMode(str, enum.Enum):
    """Boundary handling for taps that fall outside the input.

    - ``DROP``: out-of-range taps contribute nothing (equivalent to zero
      padding).  This is what the reference C oracle does by clamping its
      tap *loop bounds* (``full_TB.h:59,72``) — taps outside are skipped.
    - ``CLAMP``: out-of-range taps read the nearest edge pixel (replicate).
    - ``REFLECT``: mirror about the edge pixel.
    """

    DROP = "drop"
    CLAMP = "clamp"
    REFLECT = "reflect"


class Order(str, enum.Enum):
    """Which separable pass runs first.

    The reference C oracle is width-first (``full_TB.h:83-93``); the HLS
    hardware path is height-first (``lanczos.cpp:96-97``: "column
    lengthening first, then row lengthening").
    """

    WIDTH_FIRST = "width_first"
    HEIGHT_FIRST = "height_first"


class Align(str, enum.Enum):
    """Sample-grid alignment convention.

    - ``ZERO``: output position y samples input coordinate ``y·D/N``
      (sample-0 aligned) — the reference's convention (``full_TB.h:57``).
      Asymmetric under image reversal.
    - ``CENTER``: half-pixel-center convention ``(y+½)·D/N − ½`` — what
      PIL/OpenCV/FSR use; flip-symmetric.  The rational-phase structure
      is preserved (y→y+N shifts the coordinate by exactly D), so every
      fast path applies.
    """

    ZERO = "zero"
    CENTER = "center"


class Precision(str, enum.Enum):
    """Accumulation dtype policy.

    - ``FP32``: float32 accumulation (TPU-native default).
    - ``BF16``: bfloat16 weights/activations, fp32 accumulation (fast path).
    - ``FIXED``: int32 emulation of the reference's ``ap_fixed`` numerics
      (``lanczos.h:79-82``): weights with ``bit_precision`` fractional bits,
      truncating accumulation — the bit-faithful HLS mode.
    """

    FP32 = "fp32"
    BF16 = "bf16"
    FIXED = "fixed"


class Profile(str, enum.Enum):
    """Named semantic presets (see ``ResampleConfig.from_profile``).

    - ``PRECISE``: best-quality TPU-native resampling (normalized weights,
      clamped edges, fp32).  Not bit-matched to anything; this is the
      framework's own recommended mode.
    - ``C_ORACLE``: bit-near emulation of the reference's fp64 software
      path (``full_TB.h:51-96``): width-first, unnormalized weights,
      dropped edge taps, uint8-truncated intermediate, and the in-place
      column-pass overwrite quirk.
    - ``HLS``: bit-faithful emulation of the reference's fixed-point
      streaming hardware path (``lanczos.cpp``/``worker.cpp``):
      height-first, phase-LUT weights quantized to ``bit_precision``
      fractional bits, quantized step predicate, zero-pad top/left,
      replicate bottom/right, FSR-style dering clamp, truncating
      accumulation.
    """

    PRECISE = "precise"
    C_ORACLE = "c_oracle"
    HLS = "hls"


def reduced_scale(in_size: int, out_size: int) -> Tuple[int, int]:
    """Return (N, D) with out/in = N/D reduced.

    The runtime replacement for the reference's preprocessor fraction
    reducer (``gcd.h:13-24``, whose SIMP tables mis-handle factor 28 —
    ``INC_SIMP_A.h:79-84``) and its runtime ``SCALE_GCD`` (``lanczos.h:110``).
    """
    g = math.gcd(in_size, out_size)
    return out_size // g, in_size // g


@dataclasses.dataclass(frozen=True)
class ResampleConfig:
    """Everything the reference's ``params.h`` macros encode, at runtime.

    All fields are hashable / static so a config can be a jit-static arg.
    """

    in_shape: Tuple[int, int]  # (H, W)
    out_shape: Tuple[int, int]  # (H, W)
    a: int = 3  # Lanczos support radius (reference LANCZOS_A)
    filter: str = "lanczos"
    edge_mode: EdgeMode = EdgeMode.CLAMP
    order: Order = Order.HEIGHT_FIRST
    precision: Precision = Precision.FP32
    normalize: bool = True  # per-output-position weight normalization
    dering: bool = False  # FSR-style clamp to central taps (worker.cpp:64-75)
    intermediate_quantize: bool = False  # uint8 intermediate (full_TB.h:63)
    c_faithful: bool = False  # emulate in-place col-pass quirk (full_TB.h:67-77)
    bit_precision: int = 8  # fractional bits for FIXED (lanczos.h BIT_PRECISION)
    channels: int = 3
    align: Align = Align.ZERO  # reference convention by default

    @property
    def scale_h(self) -> Tuple[int, int]:
        return reduced_scale(self.in_shape[0], self.out_shape[0])

    @property
    def scale_w(self) -> Tuple[int, int]:
        return reduced_scale(self.in_shape[1], self.out_shape[1])

    @property
    def scale_h_fraction(self) -> Fraction:
        n, d = self.scale_h
        return Fraction(n, d)

    @property
    def scale_w_fraction(self) -> Fraction:
        n, d = self.scale_w
        return Fraction(n, d)

    @property
    def taps(self) -> int:
        return 2 * self.a

    def __post_init__(self):
        # coerce string values into the enums (frozen dataclass)
        for name, enum_t in (
            ("edge_mode", EdgeMode),
            ("order", Order),
            ("precision", Precision),
            ("align", Align),
        ):
            object.__setattr__(self, name, enum_t(getattr(self, name)))
        if self.align == Align.CENTER and (
            self.precision == Precision.FIXED or self.c_faithful
        ):
            raise ValueError(
                "center alignment applies to the framework's own float "
                "modes; the reference-parity paths are zero-aligned"
            )
        if self.a < 1:
            raise ValueError(f"support radius a must be >= 1, got {self.a}")
        if self.bit_precision < 1 or self.bit_precision > 11:
            # the vectorized fixed path accumulates 2P-frac horizontal
            # products in int32: 255·2^(2P) must stay below 2^31 → P ≤ 11
            raise ValueError("bit_precision must be in [1, 11]")
        for name in ("in_shape", "out_shape"):
            shp = getattr(self, name)
            if len(shp) != 2 or any(s < 1 for s in shp):
                raise ValueError(f"{name} must be two positive ints, got {shp}")

    @classmethod
    def from_profile(
        cls,
        profile: Profile | str,
        in_shape: Tuple[int, int],
        out_shape: Optional[Tuple[int, int]] = None,
        scale: Optional[Tuple[int, int]] = None,
        a: int = 3,  # match the dataclass default and upscale()
        **overrides,
    ) -> "ResampleConfig":
        """Build a config for a named semantic profile.

        Either ``out_shape`` or ``scale=(N, D)`` must be given; with
        ``scale``, out dims are ``in·N/D`` (must be integral), matching the
        reference's ``OUT_WIDTH = IN_WIDTH*SCALE`` convention.
        """
        profile = Profile(profile)
        if out_shape is None:
            if scale is None:
                raise ValueError("need out_shape or scale")
            n, d = scale
            if (in_shape[0] * n) % d or (in_shape[1] * n) % d:
                raise ValueError(f"scale {n}/{d} does not divide {in_shape}")
            out_shape = (in_shape[0] * n // d, in_shape[1] * n // d)
        base = dict(in_shape=tuple(in_shape), out_shape=tuple(out_shape), a=a)
        if profile == Profile.PRECISE:
            base.update(
                edge_mode=EdgeMode.CLAMP,
                order=Order.HEIGHT_FIRST,
                precision=Precision.FP32,
                normalize=True,
                dering=False,
                intermediate_quantize=False,
            )
        elif profile == Profile.C_ORACLE:
            base.update(
                edge_mode=EdgeMode.DROP,
                order=Order.WIDTH_FIRST,
                precision=Precision.FP32,
                normalize=False,
                dering=False,
                intermediate_quantize=True,
                c_faithful=True,
            )
        elif profile == Profile.HLS:
            base.update(
                edge_mode=EdgeMode.DROP,  # top/left zeros; bottom/right replicate handled by scheduler
                order=Order.HEIGHT_FIRST,
                precision=Precision.FIXED,
                normalize=False,
                dering=True,
                intermediate_quantize=False,
            )
        base.update(overrides)
        return cls(**base)
