"""Upscale a .y4m video plane-natively (no color conversion).

Usage: python examples_torch/02_video_y4m.py in.y4m out.y4m [N/D] [--device cuda]
"""
import argparse

from lanczos_torch import upscale_y4m

p = argparse.ArgumentParser()
p.add_argument("src")
p.add_argument("dst")
p.add_argument("scale", nargs="?", default="2/1")
p.add_argument("--device", default="cuda", help="cpu runs the plain PyTorch versions")
args = p.parse_args()

n, _, d = args.scale.partition("/")
scale = (int(n), int(d) if d else 1)  # accept bare "2" like the CLI
hdr = upscale_y4m(args.src, args.dst, scale=scale, a=3, batch=8, device=args.device)
print(f"wrote {args.dst}: {hdr.width}x{hdr.height} C{hdr.colorspace}")
