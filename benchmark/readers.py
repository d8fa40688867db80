"""Arithmetic that the per-layer readers (``metrics/<name>.py``) share.
Each returns ``None`` where the traced window holds nothing to read."""

from __future__ import annotations

FUSED = "fused_resample_kernel"


def device_ms_per_frame(m, keep) -> float | None:
    """Device milliseconds a frame of the traced window's operations for
    which ``keep(op)`` holds, summed over the cell's cards."""
    if m.trace is None or not m.frames:
        return None
    ops = [o for o in m.trace.ops if keep(o)]
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / m.frames * 1e3


def copy_ms_per_frame(m, kind: str) -> float | None:
    """:func:`device_ms_per_frame` of the copies of ``kind``
    (``memcpy_htod``, ``memcpy_dtoh``, ``memcpy_ptop``)."""
    return device_ms_per_frame(m, lambda o: o.kind == kind)


def idle_share(m, cards: str) -> float | None:
    """The share of the traced window, in percent, in which a card runs
    neither a kernel nor a copy: on the first card (``cards="first"``) or
    averaged over the cell's cards (``"mean"``)."""
    if m.trace is None or not m.trace.ops:
        return None
    t = m.trace
    busy = t.busy_s(t.devices[0]) if cards == "first" else t.mean_busy_s()
    return 100.0 * (1.0 - busy / t.window_s)


def roofline_share(m, kernel: str = FUSED) -> float | None:
    """The least time the card could take for the traced window's frames
    (``m.bound``: input once and output once at 3.35 TB/s, or the
    operations at 67 TFLOP/s, whichever is longer) over the device time of
    every launch of ``kernel`` in the window, in percent."""
    if m.trace is None or not m.frames:
        return None
    ops = m.trace.ops_of("kernel", kernel)
    if not ops:
        return None
    return 100.0 * m.frames * m.bound["seconds"] / sum(o.end - o.start for o in ops)
