"""Upscale an animated GIF: GIF in → upscaled animated GIF out (+ PNGs).

Demonstrates the stbi_load_gif analog (decode_gif_frames: composited
full-canvas frames + per-frame delays) feeding the batched video
pipeline, with alpha carried around the RGB upscale.

Usage: python examples_torch/05_gif_animation.py in.gif outdir/ [N/D] [--device cuda]
"""
import argparse
import pathlib

import numpy as np

from lanczos_torch import ResampleConfig
from lanczos_torch.io import convert_channels, encode_gif, write_image
from lanczos_torch.io.formats import decode_gif_frames
from lanczos_torch.models.video import VideoUpscaler

p = argparse.ArgumentParser()
p.add_argument("src")
p.add_argument("outdir")
p.add_argument("scale", nargs="?", default="2/1")
p.add_argument("--device", default="cuda", help="cpu runs the plain PyTorch versions")
args = p.parse_args()

n, _, d = args.scale.partition("/")
scale = (int(n), int(d) if d else 1)

frames, delays = decode_gif_frames(pathlib.Path(args.src).read_bytes())
t, h, w, _ = frames.shape  # RGBA on the full logical screen

sn, sd = scale
cfg = ResampleConfig(
    in_shape=(h, w), out_shape=(h * sn // sd, w * sn // sd), a=3, channels=4
)
model = VideoUpscaler(cfg, batch=min(8, t), device=args.device)
up = model(np.ascontiguousarray(frames))  # alpha rides as a 4th channel

outdir = pathlib.Path(args.outdir)
outdir.mkdir(parents=True, exist_ok=True)
for i, (frame, delay) in enumerate(zip(up, delays)):
    write_image(outdir / f"frame_{i:04d}_{delay}ms.png", frame)

# full round trip: re-encode the upscaled clip as an animated GIF
# (encode_gif is beyond-stb — stb_image_write has no GIF writer)
rgb_frames = np.stack([convert_channels(f, 3) for f in up])
(outdir / "upscaled.gif").write_bytes(
    encode_gif(rgb_frames, delays_cs=[max(1, d // 10) for d in delays])
)
print(f"wrote {t} frames at {up.shape[2]}x{up.shape[1]} to {outdir}/ "
      "(+ upscaled.gif)")
