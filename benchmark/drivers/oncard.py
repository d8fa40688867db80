"""Calls into the program on inputs that are already on the card, in a
closed loop: the next call is issued when the previous one returns, with
no synchronize inside the window.

Traffic keys:

- ``entry``: ``"planar"``, ``Upscaler(cfg, backend="auto").planar`` on
  ``(B, C, H, W)`` (``(C, H, W)`` where ``batch`` is 0); ``"upscale"``, the
  public ``lanczos_torch.upscale(x, out_shape=...)`` on ``(B, H, W, C)``
  (``(H, W, C)`` where ``batch`` is 0), which builds the config and looks up
  its cached ``Upscaler`` on every call;
- ``batch``: frames a call (0: one frame with no batch axis);
- ``distinct``: inputs made from the seed that the calls cycle through
  (together more than the card's 50 MB L2);
- ``sample``: calls kept for the check.

End-to-end values: ``mpix_s``, the output megapixels of every call issued
in the window over the time from its start to the synchronize that ends it;
``call_ms_p95``, the 95th percentile over all calls of each call's device
time, between CUDA events recorded on the stream before and after it.  A
window issues at least ``harness.MIN_CALLS`` calls.
"""

from __future__ import annotations

import time

import torch

from benchmark.devtrace import WINDOW
from benchmark.harness import MIN_CALLS, Window, log, percentile

WARM_SECONDS = 0.5  # calls after the first ones, to size the pool of events
# the values a window returns on the card
VALUES = ("mpix_s", "call_ms_p95", "window_s")


def entry(traffic: dict) -> tuple:
    """``(owner, attribute)`` of the program that each call of the window
    goes through (where the tests plant a fault in the timed path)."""
    import lanczos_torch

    if traffic["entry"] == "planar":
        return lanczos_torch.Upscaler, "planar"
    return lanczos_torch, "upscale"


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.cell.traffic
        self.entry, self.batch, self.distinct = t["entry"], int(t["batch"]), int(t["distinct"])
        if self.entry not in ("planar", "upscale"):
            raise ValueError(f"unknown entry {self.entry!r}")
        self.events: list = []

    def _shape(self) -> tuple:
        cfg = self.ctx.cfg
        (h, w), c = cfg.in_shape, cfg.channels
        one = (c, h, w) if self.entry == "planar" else (h, w, c)
        return ((self.batch,) if self.batch else ()) + one

    def setup(self) -> None:
        import lanczos_torch

        ctx, cfg = self.ctx, self.ctx.cfg
        dev = ctx.devices[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.torch_seed)
        x = torch.randint(0, 256, (self.distinct,) + self._shape(), generator=gen,
                          device=dev, dtype=torch.uint8)
        self.inputs = list(x.unbind(0))
        if self.entry == "planar":
            self.model = lanczos_torch.Upscaler(cfg, backend="auto", device=dev)
            self.fn = self.model.planar
        else:
            upscale, conf = lanczos_torch.upscale, ctx.cell.config
            kw = dict(out_shape=tuple(cfg.out_shape), profile=conf["profile"], a=cfg.a,
                      precision=cfg.precision.value)
            self.fn = lambda img: upscale(img, **kw)
        # the first calls build and upload the tables; holding as many
        # outputs as a window keeps makes the allocator hold their blocks
        held = [self.fn(self.inputs[i % self.distinct]) for i in range(int(
            ctx.cell.traffic["sample"]) + 2)]
        ctx.sync()
        del held
        if not ctx.on_card:
            return
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < WARM_SECONDS:
            self.fn(self.inputs[n % self.distinct])
            n += 1
        ctx.sync()
        self.rate = n / (time.perf_counter() - t0)

    def _pool(self, calls: int) -> None:
        """Two events a call, each recorded once here so that the window
        records events that exist on the card."""
        while len(self.events) < 2 * calls:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
        torch.cuda.synchronize(self.ctx.devices[0])

    def window(self, seconds: float, sampler) -> Window:
        ctx = self.ctx
        timed = ctx.on_card and not ctx.traced
        if timed:
            self._pool(int(self.rate * seconds * 1.25) + 512)
        ev, fn, inputs, d = self.events, self.fn, self.inputs, self.distinct
        n = 0
        ctx.sync()
        with ctx.span(WINDOW):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                if timed:
                    if 2 * n + 2 > len(ev):
                        ev += [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[2 * n].record()
                with ctx.span("bench.call"):
                    y = fn(inputs[n % d])
                if timed:
                    ev[2 * n + 1].record()
                sampler.offer(n % d, y)
                n += 1
                if n >= MIN_CALLS and time.perf_counter() >= deadline:
                    break
            ctx.sync()
            t1 = time.perf_counter()
        del y
        frames = n * max(1, self.batch)
        values = {}
        if ctx.on_card:
            oh, ow = ctx.cfg.out_shape
            values["mpix_s"] = frames * oh * ow / 1e6 / (t1 - t0)
            values["window_s"] = t1 - t0
        if timed:
            call_ms = [ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(n)]
            values["call_ms_p95"] = percentile(call_ms, 95)
            log(f"# call_ms over {n} calls: median {percentile(call_ms, 50)}, p95 "
                f"{values['call_ms_p95']}, max {max(call_ms)}")
        return Window(values, n, 0, frames)

    def input_planes(self, key) -> torch.Tensor:
        x = self.inputs[key]
        if self.entry == "upscale":
            x = x.movedim(-1, -3)
        return x.reshape((-1,) + tuple(x.shape[-2:]))

    def output_planes(self, y):
        oh, ow = self.ctx.cfg.out_shape
        c = self.ctx.cfg.channels
        one = (c, oh, ow) if self.entry == "planar" else (oh, ow, c)
        want = ((self.batch,) if self.batch else ()) + one
        if not isinstance(y, torch.Tensor) or tuple(y.shape) != want or y.dtype != torch.uint8:
            return None
        if self.entry == "upscale":
            y = y.movedim(-1, -3)
        return y.reshape(-1, oh, ow)

    def release(self) -> None:
        """Drop the program's objects (the inputs stay for the check)."""
        self.fn = self.model = None
        self.events = []
