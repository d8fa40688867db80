"""Row-partitioned multi-device upscale on a (data x rows) mesh.

Positions of the mesh may share a card (they then run one after another):
    python examples_torch/03_sharded_mesh.py --n 8          # on the cards
    python examples_torch/03_sharded_mesh.py --device cpu --n 8 --size 64x96
"""
import argparse

import numpy as np
import torch

from lanczos_torch import Mesh, ResampleConfig, ShardedUpscaler
from lanczos_torch.core.config import Profile
from lanczos_torch.models._pipeline import require_device
from lanczos_torch.parallel.mesh import choose_mesh_shape

p = argparse.ArgumentParser()
p.add_argument("--device", default="cuda", help="cpu runs the plain PyTorch versions")
p.add_argument("--n", type=int, default=8, help="mesh positions, spread over the cards")
p.add_argument("--size", default="512x768", help="frame HxW")
args = p.parse_args()

dev = require_device(args.device)
cards = torch.cuda.device_count() if dev.type == "cuda" else 1
devices = [torch.device(dev.type, i % cards) if dev.type == "cuda" else dev
           for i in range(args.n)]
h, w = (int(v) for v in args.size.split("x"))

data_n, rows_n = choose_mesh_shape(args.n)
mesh = Mesh.local(devices, (data_n, rows_n))

cfg = ResampleConfig.from_profile(Profile.PRECISE, (h, w), scale=(2, 1), a=3)
model = ShardedUpscaler(cfg, mesh)  # ring halo exchange inside

batch = 2 * data_n
img = np.random.default_rng(0).integers(0, 256, (batch, h, w, 3), np.uint8)
out = model(img).cpu().numpy()
print(f"{img.shape} -> {out.shape} across {args.n} positions ({data_n}x{rows_n} mesh)")
