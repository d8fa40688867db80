"""Literal stream-machine emulation of the reference HLS hardware path.

A slow, loop-level Python reenactment of the synthesized pipeline
(``lanczos.cpp`` / ``worker.cpp`` / ``cyclic_buffer.h``), used as the ground
truth that the vectorized TPU HLS-faithful mode (ops/fixed_point.py) must
match **bit-exactly**.  Structure mirrored (not translated line-by-line —
the cyclic buffer's index indirection is replaced by a plain Python list
with identical observable behavior):

- vertical worker: 2a-row sliding window over the input row stream,
  pre-rolled with a−1 zero rows (``worker.cpp:176-187`` with offset 0),
  advancing on the quantized step predicate
  ``frac(q·(y+1)) < q, q = ⌊2^P·D/N⌋`` (``worker.cpp:140``), freezing via
  saturate-push (replicating the newest row) past the bottom edge
  (``worker.cpp:151``, ``cyclic_buffer.h:38-41``);
- fixed-point MAC with the FSR-style dering clamp against the two central
  taps (``worker.cpp:45-78``), exact in integer units of 2^-P;
- horizontal worker per output row: same machine over columns, per-MAC
  truncation of 2P-bit products to P fractional bits (``worker.cpp:91-97``,
  ap_fixed AP_TRN assignment), replicate-right (``worker.cpp:244``), final
  ``clamp_to_byte`` = drop fractional bits, wrap to 8 (``worker.cpp:118-130``;
  the dering clamp guarantees no wrap in practice);
- ROM weights via ``|y·D − i·N|`` LUT indexing from the nominal stream
  counter (``kernel.cpp:50-59``, ``lanczos.cpp:27-30,44-48``), clipped at
  the ROM bound where the quantized predicate drifts (a latent reference
  out-of-bounds for scales inexact in P bits).
"""

from __future__ import annotations

import numpy as np

from lanczos_torch.core.config import reduced_scale
from lanczos_torch.core.weights import hls_lut


def _kernel_vals(lut: np.ndarray, y: int, in_idx: int, taps: int, n: int, d: int, a: int):
    j = np.arange(taps)
    x = np.abs(y * d - (in_idx - taps + j) * n)
    return lut[np.clip(x, 0, a * n)].astype(np.int64)


def hls_stream_upscale(
    img: np.ndarray,
    out_h: int,
    out_w: int,
    a: int = 2,
    bit_precision: int = 8,
    lut_mode: str = "fp64",
) -> np.ndarray:
    """img (H, W, C) uint8 → (out_h, out_w, C) uint8, HLS-path semantics."""
    img = np.asarray(img)
    assert img.dtype == np.uint8 and img.ndim == 3
    in_h, in_w, nc = img.shape
    P = bit_precision
    mask = (1 << P) - 1
    taps = 2 * a

    n_v, d_v = reduced_scale(in_h, out_h)
    n_h, d_h = reduced_scale(in_w, out_w)
    if n_v < d_v or n_h < d_h:
        # the quantized step predicate degenerates for q >= 2^P and would
        # return plausible-looking garbage; the HLS design is upscale-only
        raise ValueError("the HLS stream path is upscale-only")
    lut_v = hls_lut(a, n_v, P, lut_mode)
    lut_h = hls_lut(a, n_h, P, lut_mode)
    q_v = (d_v << P) // n_v
    q_h = (d_h << P) // n_h

    src = img.astype(np.int64)

    # ---- vertical pass: (out_h, in_w, C) in num units (2^-P) ----
    zeros = np.zeros((in_w, nc), dtype=np.int64)
    n_real = min(a + 1, in_h)
    win = [zeros] * (a - 1) + [src[r] for r in range(n_real)]
    while len(win) < taps:  # short input: replicate the newest row
        win.append(win[-1])
    in_idx = n_real
    V = np.empty((out_h, in_w, nc), dtype=np.int64)
    for y in range(out_h):
        kv = _kernel_vals(lut_v, y, in_idx, taps, n_v, d_v, a)
        acc = sum(int(kv[j]) * win[j] for j in range(taps))
        lo = np.minimum(win[a - 1], win[a]) << P  # byte taps as num_el_t
        hi = np.maximum(win[a - 1], win[a]) << P
        V[y] = np.clip(acc, lo, hi)
        if ((q_v * (y + 1)) & mask) < q_v:
            nxt = src[in_idx] if in_idx < in_h else win[-1]
            win = win[1:] + [nxt]
            in_idx += 1

    # ---- horizontal pass per output row: (out_h, out_w, C) uint8 ----
    out = np.empty((out_h, out_w, nc), dtype=np.uint8)
    zrow = np.zeros((nc,), dtype=np.int64)
    for y in range(out_h):
        row = V[y]
        n_real_w = min(a + 1, in_w)
        win = [zrow] * (a - 1) + [row[c] for c in range(n_real_w)]
        while len(win) < taps:
            win.append(win[-1])
        in_idx = n_real_w
        for xx in range(out_w):
            kv = _kernel_vals(lut_h, xx, in_idx, taps, n_h, d_h, a)
            # per-MAC product truncation: 2P-frac product → P-frac floor
            acc = sum((int(kv[j]) * win[j]) >> P for j in range(taps))
            lo = np.minimum(win[a - 1], win[a])
            hi = np.maximum(win[a - 1], win[a])
            v = np.clip(acc, lo, hi)
            out[y, xx] = ((v >> P) & 0xFF).astype(np.uint8)
            if ((q_h * (xx + 1)) & mask) < q_h:
                nxt = row[in_idx] if in_idx < in_w else win[-1]
                win = win[1:] + [nxt]
                in_idx += 1
    return out
