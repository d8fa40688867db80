"""Bounded-memory streaming: upscale a frame taller than you'd want
resident, chunk by chunk, with resume.

Usage: python examples_torch/04_streaming_tall_frame.py [--device cuda] [--size 4096x960]
"""
import argparse

import numpy as np

from lanczos_torch import ResampleConfig, StreamingUpscaler
from lanczos_torch.core.config import Profile

p = argparse.ArgumentParser()
p.add_argument("--device", default="cuda", help="cpu runs the plain PyTorch versions")
p.add_argument("--size", default="4096x960", help="frame HxW (chunks of H/8 rows)")
args = p.parse_args()
h, w = (int(v) for v in args.size.split("x"))

cfg = ResampleConfig.from_profile(Profile.PRECISE, (h, w), scale=(2, 1), a=3)
sm = StreamingUpscaler(cfg, chunk_rows=h // 8, device=args.device)

frame = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
rows = []
for y0, chunk in sm.chunks(lambda lo, hi: frame[lo:hi]):
    rows.append((y0, chunk))                  # host arrays, in order
out = np.concatenate([c for _, c in rows])
print(f"streamed {len(rows)} chunks -> {out.shape}")
