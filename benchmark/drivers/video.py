"""Frames from host memory through ``lanczos_torch.VideoUpscaler.frames``,
in a closed loop: the source hands in its next frame when the pipeline
pulls it, and the consumer takes each output as it is yielded and drops
it (keeping only the frames the check samples).

Traffic keys:

- ``batch``, ``depth``: ``VideoUpscaler``'s frames a launch and batches in
  flight;
- ``mesh``: ``[data, rows]``, a ``Mesh.local`` over the cell's cards, or
  null for one card;
- ``distinct``: pageable ``(H, W, C)`` uint8 frames made from the seed that
  the source cycles through;
- ``sample``: frames kept for the check.

End-to-end values: ``video_fps``, the frames yielded in the window over the
time from its start to the last frame's yield (the source stops handing in
frames at ``--seconds`` and the pipeline drains); ``video_frame_ms_p95``, the
95th percentile over all frames of the host time from when the source
handed a frame in to when ``frames()`` yielded its output.  The source
hands in at least ``harness.MIN_CALLS`` launches' frames.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark.devtrace import WINDOW
from benchmark.harness import MIN_CALLS, Window, log, percentile

# the values a window returns on the card
VALUES = ("video_fps", "video_frame_ms_p95", "window_s")


def entry(traffic: dict) -> tuple:
    """``(owner, attribute)`` of the program that each launch of the window
    goes through (where the tests plant a fault in the timed path): the
    one-card model, or the sharded one on a mesh."""
    from lanczos_torch.models.upscaler import Upscaler
    from lanczos_torch.parallel.sharded import ShardedUpscaler

    return (ShardedUpscaler if traffic.get("mesh") else Upscaler), "__call__"


def slices(times: list, t0: float, width: float) -> list:
    """The rate of events in each ``width`` seconds from ``t0`` (a whole
    window slow, or one slice of it, tell a slow run from a stall)."""
    counts = [0] * max(1, math.ceil((times[-1] - t0) / width)) if times else []
    for t in times:
        counts[min(len(counts) - 1, int((t - t0) / width))] += 1
    return [c / width for c in counts]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.cell.traffic
        self.batch, self.depth = int(t["batch"]), int(t["depth"])
        self.distinct, self.mesh_shape = int(t["distinct"]), t.get("mesh")

    def setup(self) -> None:
        import lanczos_torch

        ctx, cfg = self.ctx, self.ctx.cfg
        (h, w), c = cfg.in_shape, cfg.channels
        gen = torch.Generator(device=ctx.devices[0])
        gen.manual_seed(ctx.torch_seed)
        x = torch.randint(0, 256, (self.distinct, h, w, c), generator=gen,
                          device=ctx.devices[0], dtype=torch.uint8)
        self.frames = list(x.cpu().numpy())  # pageable host memory
        del x
        mesh = None
        if self.mesh_shape:
            n = math.prod(self.mesh_shape)
            mesh = lanczos_torch.Mesh.local(ctx.devices[:n], tuple(self.mesh_shape))
        self.vu = lanczos_torch.VideoUpscaler(cfg, batch=self.batch, depth=self.depth,
                                              mesh=mesh, device=ctx.devices[0])
        # the first batches build and upload the tables; holding as many
        # outputs as a window keeps makes the host allocator hold their
        # page-locked blocks
        warm = (int(ctx.cell.traffic["sample"]) + self.depth + 2) * self.vu.batch
        held = list(self.vu.frames(self.frames[i % self.distinct] for i in range(warm)))
        ctx.sync()
        del held

    def window(self, seconds: float, sampler) -> Window:
        ctx, frames, d = self.ctx, self.frames, self.distinct
        least = MIN_CALLS * self.vu.batch
        handed: list = []
        deadline = math.inf

        def source():
            i = 0
            while True:
                with ctx.span("bench.source"):
                    t = time.perf_counter()
                    if i >= least and t >= deadline:
                        return
                    handed.append(t)
                yield frames[i % d]
                i += 1

        latency: list = []
        yielded: list = []
        n = 0
        ctx.sync()
        with ctx.span(WINDOW):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            out = self.vu.frames(source())
            while True:
                with ctx.span("bench.next"):
                    y = next(out, None)
                if y is None:
                    break
                t = time.perf_counter()
                latency.append(t - handed[n])
                yielded.append(t)
                sampler.offer(n % d, y)
                n += 1
            t1 = time.perf_counter()
            ctx.sync()
        values = {}
        if ctx.on_card:
            values["video_fps"] = n / (t1 - t0)
            values["video_frame_ms_p95"] = percentile(latency, 95) * 1e3
            values["window_s"] = t1 - t0
            if not ctx.traced:
                log(f"# frame ms over {n} frames: median {percentile(latency, 50) * 1e3}, "
                    f"p95 {values['video_frame_ms_p95']}, max {max(latency) * 1e3}")
                log(f"# frames/s in each 10 s of the window: {slices(yielded, t0, 10.0)}")
        return Window(values, len(handed), len(handed) - n, n)

    def input_planes(self, key) -> torch.Tensor:
        return torch.from_numpy(self.frames[key]).permute(2, 0, 1)

    def output_planes(self, y):
        oh, ow = self.ctx.cfg.out_shape
        if getattr(y, "shape", None) != (oh, ow, self.ctx.cfg.channels) or y.dtype != "uint8":
            return None
        return torch.from_numpy(y).permute(2, 0, 1)

    def release(self) -> None:
        """Drop the program's objects (the frames stay for the check)."""
        self.vu = None
