"""Smoke test of the PyTorch/CUDA port (``lanczos_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing as it goes; any failure raises and the exit code is
not 0:

1. environment: a CUDA device is required (no CPU fallback); prints the
   card's name and power limit from ``nvidia-smi`` and the versions;
2. build: compiles ``lanczos_torch/csrc`` with ``nvcc`` and loads it;
3. the fused kernel against its plain PyTorch version on the card, at
   small shapes (ragged tiles and blocks, a rational scale, center
   alignment, a batch, a shared-memory-heavy downscale), fp32 and bf16;
4. the main path: ``lanczos_torch.upscale(img, scale=(2, 1),
   profile="precise", a=3)`` on a seeded 2160×3840×3 uint8 frame in fp32
   and bf16, with the kernel's launch counts, held against a float64
   numpy separable gather and against the plain version;
5. times of the kernel and the plain version at 4K→8K (CUDA events).

Limits, for every comparison: fp32 ≤ 1 LSB on ≤ 1% of pixels; bf16 ≤ 3 LSB
on ≤ 50% of pixels.  The last lines are one JSON object of the kernels and
one of the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}
FP32_PEAK_TFLOPS = 67.0  # H100 SXM, SIMT fp32, NVIDIA's data sheet at 700 W


def compare(name: str, got, want, precision: str) -> tuple[int, float]:
    """Max |Δ| and the share of differing pixels; raises past the limits."""
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    want = want.detach().cpu().numpy() if hasattr(want, "detach") else want
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{name}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}"
        )
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    mx, frac = int(d.max()), float((d > 0).mean())
    lim, frac_lim = LIMITS[precision]
    ok = mx <= lim and frac <= frac_lim
    print(f"  {name}: max|d|={mx} differing={frac:.6f} "
          f"(limit {lim} on {frac_lim}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} outside the {precision} limits")
    return mx, frac


def gather_f64(img: np.ndarray, cfg) -> np.ndarray:
    """Float64 separable gather, height first, from the port's
    banded_weights: the (H, W, C) uint8 reference of a precise config."""
    from lanczos_torch.core.weights import banded_weights

    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    kw = dict(a=cfg.a, filter_name=cfg.filter, edge_mode=cfg.edge_mode,
              normalize=cfg.normalize, align=cfg.align.value)
    op_v, op_h = banded_weights(ih, oh, **kw), banded_weights(iw, ow, **kw)
    mid = np.zeros((oh, iw, img.shape[2]), np.float64)
    for j in range(op_v.taps):
        mid += op_v.weights[:, j, None, None] * img[op_v.idx[:, j]]
    out = np.zeros((oh, ow, img.shape[2]), np.float64)
    for j in range(op_h.taps):
        out += op_h.weights[None, :, j, None] * mid[:, op_h.idx[:, j]]
    return np.trunc(np.clip(out, 0.0, 255.0)).astype(np.uint8)


def dense_flops(plan, nc: int) -> float:
    """Flops of the kernel's dense products over one call (padding included)."""
    r8 = lambda v, m: -(-v // m) * m  # noqa: E731
    tile_p, kh_p, cb_p = r8(plan.tile_out, 8), r8(plan.kh, 8), r8(plan.cb, 4)
    per_block = kh_p * tile_p * plan.kv + tile_p * cb_p * plan.kh
    return 2.0 * nc * plan.num_tiles * plan.n_cb * per_block


def _plan_with(cfg, tile: int, cb: int):
    """A plan at given tile and block targets (the generic-shape cases)."""
    from lanczos_torch.core.config import reduced_scale
    from lanczos_torch.core.weights import banded_weights
    from lanczos_torch.ops.resample_cuda import build_fused_plan

    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    nv, dv = reduced_scale(ih, oh)
    kw = dict(a=cfg.a, edge_mode=cfg.edge_mode, normalize=cfg.normalize,
              align=cfg.align.value)
    off_v = 0 if cfg.align.value == "zero" else dv - nv
    plan = build_fused_plan(cfg, tile, banded_weights(ih, oh, **kw),
                            banded_weights(iw, ow, **kw), nv, dv, off_v, cb)
    if plan is None:
        raise AssertionError(f"no plan at tile {tile}, cb {cb} for {cfg}")
    return plan


def main() -> None:
    import torch

    # ---- 1. environment
    print("== 1. environment", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing was run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {kind}", flush=True)

    import lanczos_torch
    from lanczos_torch.ops import _build, resample_cuda as rc
    from lanczos_torch.utils.timing import cuda_time_ms

    # ---- 2. build
    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"  built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel against plain version, small shapes
    print("== 3. kernel vs plain version, small shapes", flush=True)
    rng = np.random.default_rng(0)
    cases = [  # name, (h, w), scale, batch, overrides, plan (tile, cb) or None
        ("2/1 ragged tile+block 100x300", (100, 300), (2, 1), 1, {}, None),
        ("3/2 rational 96x160", (96, 160), (3, 2), 1, {}, None),
        ("2/1 align=center 90x130", (90, 130), (2, 1), 1, {"align": "center"}, None),
        ("2/1 batch-2 planar 64x96", (64, 96), (2, 1), 2, {}, None),
        ("3/2 tile 16, cb 384 96x600", (96, 600), (3, 2), 1, {}, (16, 384)),
        ("1/2 downscale 128x512 (>48 KB smem)", (128, 512), (1, 2), 1, {}, None),
    ]
    for precision in ("fp32", "bf16"):
        for name, (h, w), scale, batch, kw, tiles in cases:
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", (h, w), scale=scale, a=3, precision=precision, **kw
            )
            plan = None
            if tiles is not None:
                plan = _plan_with(cfg, *tiles)
            ops = rc.FusedOps(cfg, "cuda", plan)
            x = torch.from_numpy(
                rng.integers(0, 256, (batch * 3, h, w), dtype=np.uint8)
            ).cuda()
            got = rc.fused_call(ops, x)
            want = rc.fused_resample_reference(x, ops.plan, precision, cfg.out_shape)
            torch.cuda.synchronize()
            compare(f"{precision} {name} (smem {ops.plan.smem_bytes()} B)",
                    got, want, precision)

    # ---- 4. main path
    print("== 4. main path: upscale 2160x3840x3 -> 4320x7680x3, a=3, precise",
          flush=True)
    img = np.random.default_rng(0).integers(0, 256, (2160, 3840, 3), dtype=np.uint8)
    x = torch.from_numpy(img).cuda()
    torch.cuda.synchronize()
    for k in rc.launches:
        rc.launches[k] = 0
    outs = {
        "fp32": lanczos_torch.upscale(x, scale=(2, 1), profile="precise", a=3),
        "bf16": lanczos_torch.upscale(
            x, scale=(2, 1), profile="precise", a=3, precision="bf16"
        ),
    }
    torch.cuda.synchronize()
    counts = dict(rc.launches)
    print(f"  launches during the main path: {counts}", flush=True)
    for k, n in counts.items():
        if n < 1:
            raise AssertionError(f"kernel {k} was not launched by the main path")
    cfgs = {
        p: lanczos_torch.ResampleConfig.from_profile(
            "precise", (2160, 3840), scale=(2, 1), a=3, precision=p
        )
        for p in outs
    }
    for p, y in outs.items():
        if tuple(y.shape) != (4320, 7680, 3) or y.dtype != torch.uint8 or not y.is_cuda:
            raise AssertionError(f"{p}: got {tuple(y.shape)} {y.dtype} {y.device}")
    t0 = time.perf_counter()
    ref64 = gather_f64(img, cfgs["fp32"])
    print(f"  float64 numpy gather reference: {time.perf_counter() - t0:.1f} s",
          flush=True)
    planar = x.permute(2, 0, 1).contiguous()
    errs = {}
    for p, y in outs.items():
        compare(f"{p} upscale vs float64 gather", y, ref64, p)
        plan = rc.fused_plan(cfgs[p])
        plain = rc.fused_resample_reference(planar, plan, p, cfgs[p].out_shape)
        errs[p], _ = compare(f"{p} upscale vs plain version",
                             y, plain.permute(1, 2, 0), p)
        del plain
    del outs, ref64
    torch.cuda.empty_cache()

    # ---- 5. times
    print("== 5. times at 4K->8K (3 planes, CUDA events, mean of 20 after 3 warm-up; "
          "order plain, kernel, kernel, plain)", flush=True)
    kernels = []
    for p, cfg in cfgs.items():
        ops = rc.FusedOps(cfg, "cuda")
        plan = ops.plan

        def plain_fn():
            return rc.fused_resample_reference(planar, plan, p, cfg.out_shape)

        def kernel_fn():
            return rc.fused_call(ops, planar)

        runs = [cuda_time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
        plain_ms, kernel_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        tflops = dense_flops(plan, 3) / (kernel_ms * 1e-3) / 1e12
        print(f"  {p}: kernel {runs[1]:.4f} / {runs[2]:.4f} ms/frame, plain version "
              f"{runs[0]:.4f} / {runs[3]:.4f} ms/frame; kernel {tflops:.2f} TFLOP/s "
              f"dense ({tflops / FP32_PEAK_TFLOPS:.3f} of the {FP32_PEAK_TFLOPS} "
              f"fp32 peak) [{smi}]", flush=True)
        kernels.append({
            "name": ops.kernel,
            "route": "cuda",
            "source": "lanczos_torch/csrc/fused_resample.cu",
            "replaces": "lanczos_tpu/ops/resample_pallas.py:849",
            "launches": counts[ops.kernel],
            "max_abs_err": errs[p],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        })

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
