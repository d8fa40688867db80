"""The traced window: a ``torch.profiler`` session around it, reduced in
memory to what the per-layer readers need.

Device operations are the profiler's kernel, memcpy and memset events on the
cards (CUPTI), clipped to the window, which is the span of the benchmark's
own ``bench.window`` annotation.  Host events of the thread that drives the
window name the idle gaps.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from collections import defaultdict
from typing import Optional

import torch

WINDOW = "bench.window"
SPAN_PREFIX = "bench."


def kind_of(name: str) -> str:
    """``kernel``, ``memset`` or ``memcpy_<direction>`` (``htod``, ``dtoh``,
    ``dtod``, ``ptop``, ...) of a device event's name."""
    if name.startswith("Memset"):
        return "memset"
    m = re.match(r"Memcpy (\w+)", name)
    return f"memcpy_{m.group(1).lower()}" if m else "kernel"


def short_name(name: str) -> str:
    """A device operation's name without ``void``, its namespace if
    anonymous, its arguments and its template arguments."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name[:96]
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.sub(r"<.*", "", name.split("(")[0])[:96]


@dataclasses.dataclass
class DeviceOp:
    device: int
    kind: str
    name: str
    start: float  # seconds from the window's start
    end: float


@dataclasses.dataclass
class HostEvent:
    name: str
    start: float
    end: float


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    devices: list  # card indices the cell uses
    ops: list  # DeviceOp, every card
    host: list  # HostEvent of the driving thread, sorted by start
    _starts: list = dataclasses.field(default_factory=list, repr=False)

    def ops_of(self, kind: Optional[str] = None, contains: Optional[str] = None) -> list:
        return [o for o in self.ops if (kind is None or o.kind == kind)
                and (contains is None or contains in o.name)]

    def busy_s(self, device: int) -> float:
        return sum(e - s for s, e in merged((o.start, o.end) for o in self.ops
                                           if o.device == device))

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def idle_gaps(self, device: int) -> list:
        """``(start, seconds)`` of every stretch of the window in which
        ``device`` runs nothing."""
        busy = merged((o.start, o.end) for o in self.ops if o.device == device)
        gaps, t = [], 0.0
        for s, e in busy:
            if s > t:
                gaps.append((t, s - t))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s - t))
        return gaps

    def host_at(self, t: float) -> str:
        """What the driving thread was doing at ``t``: its innermost
        benchmark span and its innermost operation there."""
        if len(self._starts) != len(self.host):
            self._starts = [h.start for h in self.host]
        k = bisect.bisect_right(self._starts, t)
        span, op = None, None
        for h in reversed(self.host[max(0, k - 4096):k]):
            if h.end < t:
                continue
            if h.name.startswith(SPAN_PREFIX):
                span = h.name
                break
            if op is None:
                op = h.name
        return f"{span or 'outside'}:{op or '-'}"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = defaultdict(float)
        for o in self.ops:
            by_name[short_name(o.name)] += o.end - o.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for d in self.devices:
            gaps += [(f"cuda:{d} {self.host_at(s)}", n) for s, n in self.idle_gaps(d)]
        gaps = sorted(gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def session(cards: bool = True):
    """A profiler over CPU activity and, with ``cards``, CUDA activity;
    yields a list that holds the profiler once it has stopped."""
    from torch.profiler import ProfilerActivity, profile

    out: list = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield out
    finally:
        prof.stop()
        out.append(prof)


def summarize(prof, devices: list) -> TraceSummary:
    """The window's device operations and the driving thread's host events,
    in seconds from the window's start."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} '{WINDOW}' spans, not one")
    w0, w1 = marks[0].start_ns(), marks[0].end_ns()
    tid = marks[0].start_thread_id()
    ops, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t < w0 or s > w1:
            continue
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX) or e.is_user_annotation():
                continue
            ops.append(DeviceOp(e.device_index(), kind_of(name), name,
                                (max(s, w0) - w0) * 1e-9, (min(t, w1) - w0) * 1e-9))
        elif e.start_thread_id() == tid and name != WINDOW:
            host.append(HostEvent(name, (s - w0) * 1e-9, (t - w0) * 1e-9))
    host.sort(key=lambda h: (h.start, -h.end))
    return TraceSummary((w1 - w0) * 1e-9, list(devices), ops, host)


def annotate(name: str):
    """The benchmark's own span, seen by the profiler."""
    return torch.profiler.record_function(name)
