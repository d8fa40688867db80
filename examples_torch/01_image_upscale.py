"""Upscale one image 2x with the default (precise) profile on the card.

Usage: python examples_torch/01_image_upscale.py in.png out.png [--device cuda]
"""
import argparse

from lanczos_torch import upscale
from lanczos_torch.io import read_image, write_png

p = argparse.ArgumentParser()
p.add_argument("src")
p.add_argument("dst")
p.add_argument("--device", default="cuda", help="cpu runs the plain PyTorch versions")
args = p.parse_args()

img = read_image(args.src)                 # (H, W, C) uint8 — PNG/JPEG/BMP/...
out = upscale(img, scale=(2, 1), a=3, device=args.device).cpu().numpy()
write_png(args.dst, out)
print(f"{img.shape} -> {out.shape} written to {args.dst}")
