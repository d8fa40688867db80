"""Command-line interface of the port (``python -m lanczos_torch``).

The counterpart of ``lanczos_tpu/cli.py``, which mirrors the reference
testbench workflow (``full_TB.h:99-180``): load an image, run the device
path ("observed"), optionally run the software oracle ("expected"), print
RMS/PSNR, and write outputs with the config-encoded filename pattern
``WxH->WxH_N|D_a-`` (``full_TB.h:170``).  The flags, defaults, messages and
checks are the JAX CLI's; the port adds ``--device`` (default ``cuda``:
with no card the command fails instead of running on the CPU; ``--device
cpu`` runs the kernels' plain PyTorch versions) and times ``--bench`` with
CUDA events on an input already on the card.

Usage:
    python -m lanczos_torch input.png [output.png]
        [--scale N/D | --out-size WxH] [--a 3] [--profile precise]
        [--backend auto|xla|pallas|ref] [--filter lanczos]
        [--expected] [--no-psnr] [--bench N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _parse_scale(s: str):
    if "/" in s:
        n, d = s.split("/", 1)
        return int(n), int(d)
    if "." in s:
        raise ValueError("scale must be a rational N/D (e.g. 2/1), not a float")
    return int(s), 1


def _parse_size(s: str):
    w, h = s.lower().split("x", 1)
    return int(h), int(w)  # stored (H, W)


def _bench_ms(model, x, iters: int) -> float:
    """Mean ms a call of ``model(x)`` after one warm call: CUDA events on
    the card, the host clock on the CPU."""
    if x.is_cuda:
        from lanczos_torch.utils.timing import cuda_time_ms

        return cuda_time_ms(model, x, iters=iters, warmup=1)
    model(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        model(x)
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="lanczos_torch",
        description="Lanczos image resampler on an NVIDIA H100 (PyTorch and "
                    "hand-written CUDA kernels)",
    )
    p.add_argument("input", help="input image path (any read_image format)")
    p.add_argument("output", nargs="?", help="output path; format from extension "
                   "(png/jpg/bmp/tga/pnm; default: derived .png)")
    p.add_argument("--scale", type=_parse_scale, default=None,
                   help="rational scale N/D (e.g. 2/1, 3/2)")
    p.add_argument("--out-size", type=_parse_size, default=None, metavar="WxH")
    p.add_argument("--a", type=int, default=3, help="Lanczos support radius")
    p.add_argument("--profile", default="precise",
                   choices=["precise", "c_oracle", "hls"])
    p.add_argument("--backend", default="auto",
                   choices=["auto", "shift_xla", "block", "xla", "pallas", "c_exact", "ref"])
    p.add_argument("--filter", default="lanczos")
    p.add_argument("--precision", default=None, choices=["fp32", "bf16"],
                   help="accumulation tier for the precise profile "
                        "(bf16: <=3 LSB vs fp32)")
    p.add_argument("--align", default="zero", choices=["zero", "center"],
                   help="grid alignment: zero (reference) or center (PIL-style)")
    p.add_argument("--expected", action="store_true",
                   help="also write the software-oracle output PNG")
    p.add_argument("--no-psnr", action="store_true",
                   help="skip the oracle comparison print")
    p.add_argument("--bench", type=int, default=0, metavar="N",
                   help="time N device iterations and print Mpix/s")
    p.add_argument("--info", action="store_true",
                   help="print the image header (stbi_info analog) and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    args = p.parse_args(argv)

    if args.info:
        from lanczos_torch.io import probe_image

        with open(args.input, "rb") as f:
            data = f.read()
        tga = args.input.lower().endswith((".tga", ".icb", ".vda", ".vst"))
        info = probe_image(data, tga=tga)
        print(
            f"{args.input}: {info.format} {info.width}x{info.height} "
            f"{info.channels}ch {info.bits}-bit"
            + (" (hdr)" if info.is_hdr else "")
        )
        return 0

    if args.backend == "c_exact" and args.profile != "c_oracle":
        p.error("--backend c_exact implements the c_oracle semantics; "
                "use --profile c_oracle with it")

    import torch

    from lanczos_torch.core.config import Profile, ResampleConfig
    from lanczos_torch.io import read_image, write_image
    from lanczos_torch.models.upscaler import Upscaler
    from lanczos_torch.utils.metrics import psnr, rms_error

    if args.input.lower().endswith(".y4m"):
        # video mode: plane-native YCbCr upscale, file -> file
        from lanczos_torch.models.video import upscale_y4m

        if args.bench or args.expected:
            p.error("--bench/--expected apply to still images, not .y4m "
                    "video (use bench_suite.py for video timing)")
        if args.precision and args.profile != "precise":
            p.error("--precision applies to the precise profile only "
                    "(c_oracle/hls are bit-exact integer semantics; an "
                    "fp32 override would silently change them)")
        if args.scale is None and args.out_size is None:
            args.scale = (2, 1)
        out_path = args.output or (
            os.path.splitext(args.input)[0] + "_upscaled.y4m"
        )
        t0 = time.perf_counter()
        vkw = {}
        if args.precision:
            from lanczos_torch.core.config import Precision

            vkw["precision"] = Precision(args.precision)
        hdr = upscale_y4m(
            args.input, out_path, scale=args.scale, out_shape=args.out_size,
            profile=args.profile, a=args.a, backend=args.backend,
            filter=args.filter, align=args.align, device=args.device, **vkw,
        )
        dt = time.perf_counter() - t0
        print(f"wrote {out_path}  ({hdr.width}x{hdr.height} C{hdr.colorspace}, "
              f"{args.profile}, {dt:.2f} s incl. compile)")
        return 0

    img = read_image(args.input)
    if img.shape[-1] == 4:
        img = img[..., :3]  # drop alpha for parity with the RGB reference
    elif img.shape[-1] == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    h, w = img.shape[:2]

    if args.out_size is None and args.scale is None:
        args.scale = (2, 1)
    overrides = {}
    if args.precision:
        from lanczos_torch.core.config import Precision

        if args.profile != "precise":
            p.error("--precision applies to the precise profile only "
                    "(c_oracle/hls are bit-exact integer semantics; an "
                    "fp32 override would silently change them)")
        overrides["precision"] = Precision(args.precision)
    cfg = ResampleConfig.from_profile(
        Profile(args.profile), (h, w),
        out_shape=args.out_size, scale=args.scale,
        a=args.a, filter=args.filter, align=args.align, **overrides,
    )
    oh, ow = cfg.out_shape

    model = Upscaler(cfg, backend=args.backend, device=args.device)
    t0 = time.perf_counter()
    out = model(img).cpu().numpy()
    dt = time.perf_counter() - t0
    if out.dtype != np.uint8:  # ref backend may return float
        out = np.trunc(np.clip(out, 0, 255)).astype(np.uint8)

    n, d = cfg.scale_h
    tag = f"{w}x{h}->{ow}x{oh}_{n}|{d}_{args.a}-"  # full_TB.h:170 pattern
    out_path = args.output or os.path.join(
        os.path.dirname(args.input) or ".", tag + "observed.png"
    )
    write_image(out_path, out)
    print(f"wrote {out_path}  ({w}x{h} -> {ow}x{oh}, {args.profile}, "
          f"backend={model.backend}, first-call {dt*1e3:.1f} ms)")

    if not args.no_psnr or args.expected:
        # the reference testbench's "expected" is ALWAYS the fp64 software
        # oracle (full_TB.h:141 lanczos_expected), regardless of which path
        # produced "observed" — so the RMS print is the cross-implementation
        # number the reference reports (e.g. ~13 for the hls profile at
        # 2x/a=2, full_TB.h:166), not a same-semantics self-check.
        # The C oracle is upscale-only / lanczos-only / zero-aligned
        # (full_TB.h never downscales); outside that domain fall back to
        # the fp64 ref backend evaluated with the SAME config.
        oracle_ok = (
            args.filter == "lanczos" and args.align == "zero"
            and oh >= h and ow >= w
        )
        if oracle_ok:
            from lanczos_torch.ref.oracle import c_oracle_upscale

            expected = c_oracle_upscale(img, oh, ow, args.a)
            label = "fp64 oracle"
        else:
            from lanczos_torch.ref.oracle import clean_resample_2d

            exp_f = clean_resample_2d(img, cfg)
            expected = (
                exp_f if exp_f.dtype == np.uint8
                else np.trunc(np.clip(exp_f, 0, 255)).astype(np.uint8)
            )
            label = "fp64 ref backend (config outside the C oracle's domain)"
        if args.expected:
            ex_path = os.path.join(
                os.path.dirname(out_path) or ".", tag + "expected.png"
            )
            write_image(ex_path, expected)
            print(f"wrote {ex_path}")
        if not args.no_psnr:
            print(f"RMS error vs {label}: {rms_error(out, expected):.4f}  "
                  f"PSNR: {psnr(out, expected):.2f} dB")

    if args.bench > 0:
        x = torch.from_numpy(img).to(model.device)
        per = _bench_ms(model, x, args.bench) * 1e-3
        print(f"bench: {per*1e3:.2f} ms/frame  {oh*ow/1e6/per:.1f} Mpix/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
