"""Multi-device video streaming + a frame streamed as rows-sharded chunks.

A frame stream through a (data x rows) mesh — frames data-parallel, each
frame's rows halo-exchanged — and, second, a single tall frame streamed as
rows-sharded chunk groups so no device ever holds it whole.  Positions of
the mesh may share a card:
    python examples_torch/06_sharded_video_stream.py --n 8
    python examples_torch/06_sharded_video_stream.py --device cpu --n 8 --size 32x48
"""
import argparse

import numpy as np
import torch

from lanczos_torch import Mesh, ResampleConfig
from lanczos_torch.core.config import Profile
from lanczos_torch.models._pipeline import require_device
from lanczos_torch.models.streaming import ShardedStreamingUpscaler
from lanczos_torch.models.video import VideoUpscaler
from lanczos_torch.parallel.mesh import choose_mesh_shape

p = argparse.ArgumentParser()
p.add_argument("--device", default="cuda", help="cpu runs the plain PyTorch versions")
p.add_argument("--n", type=int, default=8, help="mesh positions, spread over the cards")
p.add_argument("--size", default="256x384", help="frame HxW (the tall frame: n*H x H)")
args = p.parse_args()

dev = require_device(args.device)
cards = torch.cuda.device_count() if dev.type == "cuda" else 1
devices = [torch.device(dev.type, i % cards) if dev.type == "cuda" else dev
           for i in range(args.n)]
n = args.n
h, w = (int(v) for v in args.size.split("x"))
rng = np.random.default_rng(0)

# 1) frame stream over the mesh: the reference's stream-feed loop
#    (full_TB.h:127-138) promoted to (data x rows)
data_n, rows_n = choose_mesh_shape(n)
mesh = Mesh.local(devices, (data_n, rows_n))
cfg = ResampleConfig.from_profile(Profile.PRECISE, (h, w), scale=(2, 1), a=3)
vu = VideoUpscaler(cfg, mesh=mesh, batch=data_n, depth=2)


def camera(k):  # any iterable of frames works; here a synthetic feed
    for _ in range(k):
        yield rng.integers(0, 256, (h, w, 3), np.uint8)


count = sum(1 for _ in vu.frames(camera(3 * data_n + 1)))
print(f"streamed {count} frames through the {data_n}x{rows_n} mesh")

# 2) one frame taller than any shard's memory, streamed as rows-sharded
#    chunk groups
rmesh = Mesh.local(devices, (n,), ("rows",))
tall = ResampleConfig.from_profile(Profile.PRECISE, (n * h, h), scale=(2, 1), a=3)
sm = ShardedStreamingUpscaler(tall, rmesh, chunk_rows=h // 4)
frame = rng.integers(0, 256, (n * h, h, 3), np.uint8)
rows_out = sum(c.shape[0] for _, c in sm.chunks(lambda lo, hi: frame[lo:hi]))
print(f"tall frame: {frame.shape[0]} rows in, {rows_out} rows out, "
      f"window {sm.win} rows/shard across {n} shards")
