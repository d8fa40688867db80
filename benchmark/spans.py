"""Arithmetic on the program's own spans that the span readers
(``metrics/<name>.py``) share.

``lanczos_torch`` records a span at each layer boundary while a profiler
runs (``lanczos_torch/utils/tracing.py``); the traced window's summary
keeps them among the driving thread's host events (``TraceSummary.host``).
The names are written out here, not imported from the program, so that a
checkout of the program without them reads nothing.  Each function returns
``None`` where the window holds no span of the name it reads: a renamed
span drops its metric instead of reading 0.

Every span metric describes the traced window, not the measured one.  The
profiler costs the host microseconds for each aten op and CUDA call a span
encloses, so a span's time is its untraced time plus that cost, and a cell
whose host has little slack untraced can turn host-bound under the
profiler.  A span's time moves with the host work inside it (fewer ops,
a faster copy); a wait or an idle share moves with the balance of host and
card in the traced window, which the profiler shifts towards the host.
"""

from __future__ import annotations

from benchmark.devtrace import merged

UPSCALE = "lanczos_torch.upscale"
UPSCALER_CALL = "lanczos_torch.upscaler.call"
UPSCALER_PLANAR = "lanczos_torch.upscaler.planar"
ENTRY = (UPSCALE, UPSCALER_CALL, UPSCALER_PLANAR)  # one boundary: the public entry
LANE_HOST_COPY = "lanczos_torch.lane.host_copy"
LANE_SUBMIT = "lanczos_torch.lane.submit"
LANE_WAIT = "lanczos_torch.lane.wait"
SHARDED_CALL = "lanczos_torch.sharded.call"
# the profiler's host event for a launch that waits for room in the card's
# queue: time the host spent blocked behind the card, not working
BLOCKED = "Command Buffer Full"


def intervals(m, *names) -> list | None:
    """``(start, end)`` in seconds of the driving thread's host events
    named one of ``names``, clipped to the traced window, by start (an
    enclosing span before the spans it encloses)."""
    if m.trace is None:
        return None
    w = m.trace.window_s
    out = [(max(h.start, 0.0), min(h.end, w)) for h in m.trace.host if h.name in names]
    return sorted(out, key=lambda se: (se[0], -se[1])) or None


def ms_per_frame(m, name: str) -> float | None:
    """The spans' total host milliseconds over the window's frames."""
    spans = intervals(m, name)
    if spans is None or not m.frames:
        return None
    return sum(e - s for s, e in spans) / m.frames * 1e3


def outermost(spans: list) -> list:
    """The spans of a list sorted by start (an enclosing span first) that
    no other span of it encloses."""
    out: list = []
    for s, e in spans:
        if out and e <= out[-1][1]:
            continue
        out.append((s, e))
    return out


def own_mean_ms(m, names) -> float | None:
    """The mean host milliseconds of the outermost spans named one of
    ``names`` (one a call where the names mark one boundary), less the
    time inside them that the host spent blocked on a full launch queue
    (:data:`BLOCKED`)."""
    spans = intervals(m, *names)
    if spans is None:
        return None
    top = outermost(spans)
    total = sum(e - s for s, e in top)
    blocked = intervals(m, BLOCKED)
    if blocked:
        total -= overlap_s(top, merged(blocked))
    return total / len(top) * 1e3


def overlap_s(a: list, b: list) -> float:
    """Seconds that two sorted lists of disjoint ``(start, end)`` share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(m, name: str) -> float | None:
    """Of each card's idle time in the window (``TraceSummary.idle_gaps``),
    the share in percent during which the driving thread was inside a span
    ``name``, averaged over the cell's cards."""
    spans = intervals(m, name)
    if spans is None:
        return None
    union = merged(spans)
    t = m.trace
    shares = []
    for d in t.devices:
        gaps = [(s, s + n) for s, n in t.idle_gaps(d)]
        idle = sum(e - s for s, e in gaps)
        if idle > 0.0:
            shares.append(100.0 * overlap_s(gaps, union) / idle)
    return sum(shares) / len(shares) if shares else None
