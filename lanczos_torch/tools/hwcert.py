"""On-card certification of the port: a seeded config fuzz of
``backend="pallas"`` against the exact float64 result, as a runnable
artifact (the counterpart of the JAX package's ``hwcert.py``).

    python -m lanczos_torch.tools.hwcert [--seeds 40] [--seed0 0] [--out report.jsonl]

Each fuzz seed draws one configuration across scales × edge modes × align
× dering × quantize × order × precision × batch exactly as ``hwcert.py``
draws it (the same random calls in the same order, so seed ``k`` is the
same config in both reports), runs ``Upscaler(cfg, backend="pallas")`` on
the card (the fused kernel where a plan fits, else kernel 2 for an
integer scale, else v1) and holds it to a float64 separable gather on the
host (``lanczos_torch.ref.gather_f64``):

- fp32: |Δ| ≤ 1 LSB on ≤ 1% of pixels; with the quantized intermediate
  |Δ| ≤ 2 (one truncation-boundary flip in the uint8 intermediate spreads
  over the horizontal taps) on ≤ 1%;
- bf16: |Δ| ≤ 3 LSB on ≤ 50% of pixels, dering included (``hwcert.py``'s
  5% for bf16 dering was measured against the bf16 gather path, not
  against the exact result).

Every drawn config has a fused plan, so the fused kernel runs it; where
kernel 2 or v1 also takes it, the same config runs again as if no plan
fit (``FusedOps(cfg, variant="v1")``: kernel 2 for an integer scale, else
v1) under the same gate (``no_fused_plan``).  Beside the gate each row
reports the difference from the port's own ``backend="xla"`` gather on
the same device (``max_diff_xla``, ``frac_diff_xla``: the comparison the
JAX script gated on) and the kernels the call launched (``kernels``;
``mxu``: the fused kernel ran).
The other classes: the bit-exact profiles (``hls``, ``c_oracle``) byte for
byte against the host oracles, which run in worker processes while the
card works; anisotropic scales; uint16 (≤ 1 LSB of 16 bits on ≤ 1%
against the float64 gather); and a 24-frame ``.y4m`` per colorspace
through ``upscale_y4m`` against ``clean_resample_2d``.

Prints one JSON line per row and a summary line (also written to
``--out`` as it goes) and exits 1 on any failed row, 2 when there is no
CUDA device and neither ``--cpu-smoke`` nor ``--device cpu`` was given:
it never falls back to the CPU.  ``--cpu-smoke`` runs reduced sizes on
the CPU, where ``backend="pallas"`` takes the kernels' plain versions (it
is NOT the certification).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

SCALES = [(2, 1), (3, 1), (4, 1), (3, 2), (5, 4), (7, 3), (1, 2), (2, 3)]
EDGES = ["clamp", "reflect", "drop"]
# seed offsets of the classes, as hwcert.py has them
EXACT_SEED0, ANISO_SEED0, U16_SEED0, Y4M_SEED = 10_000, 20_000, 30_000, 40_000


def draw_config(rng: np.random.Generator, cpu_smoke: bool):
    """One random certification config (+ matching input dims)."""
    from lanczos_torch.core.config import (
        Align, EdgeMode, Order, Precision, Profile, ResampleConfig,
    )

    n, d = SCALES[rng.integers(len(SCALES))]
    a = int(rng.integers(2, 4))
    lo, hi = (6, 16) if cpu_smoke else (12, 48)
    h = int(rng.integers(lo, hi)) * 8
    w = int(rng.integers(lo, hi)) * 8
    h -= h % (8 * d)
    w -= w % (8 * d)
    kw = dict(
        a=a,
        edge_mode=EdgeMode(EDGES[rng.integers(len(EDGES))]),
        align=Align("center" if rng.integers(2) else "zero"),
        dering=bool(rng.integers(2)),
        intermediate_quantize=bool(rng.integers(2)),
        order=Order("width_first" if rng.integers(2) else "height_first"),
        precision=(
            Precision.BF16
            if rng.integers(4) == 0 and not cpu_smoke
            else Precision.FP32
        ),
        normalize=True,
    )
    if kw["edge_mode"] == EdgeMode.DROP and not bool(rng.integers(2)):
        kw["normalize"] = False
    batch = int(rng.choice([1, 1, 4]))
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (h, w), scale=(n, d), **kw
    )
    return cfg, batch


def tolerance(cfg) -> int:
    from lanczos_torch.core.config import Precision

    if cfg.precision == Precision.BF16:
        return 3
    if cfg.intermediate_quantize:
        return 2
    return 1


def frac_limit(cfg) -> float:
    """The share of pixels that may differ from the exact result."""
    from lanczos_torch.core.config import Precision

    return 0.50 if cfg.precision == Precision.BF16 else 0.01


def launch_counts() -> dict:
    """Kernel launches of this process so far, by kernel (every wrapper's
    count)."""
    from lanczos_torch.ops import resample_cuda as rc
    from lanczos_torch.ops import resample_phase_cuda as rp
    from lanczos_torch.ops import resample_shift_cuda as rs

    return {k: n for counts in (rc.launches, rs.launches, rp.launches)
            for k, n in counts.items()}


def _launched(fn) -> tuple:
    """``fn()``'s output on the host and the kernels it launched."""
    before = launch_counts()
    y = fn().cpu().numpy()  # the copy waits for the card
    return y, {k: n - before[k] for k, n in launch_counts().items() if n > before[k]}


def _diff(got: np.ndarray, want: np.ndarray) -> tuple:
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def _gather(img: np.ndarray, cfg) -> np.ndarray:
    """``gather_f64`` over the leading (batch) axes of ``img``."""
    from lanczos_torch.ref.gather import gather_f64

    if img.ndim == 3:
        return gather_f64(img, cfg)
    return np.stack([gather_f64(im, cfg) for im in img])


def run_seed(seed: int, cpu_smoke: bool, device="cuda", cfg=None, batch=None) -> dict:
    import torch

    from lanczos_torch.models.upscaler import Upscaler
    from lanczos_torch.ops.resample_cuda import FusedOps, resample_2d_cuda

    rng = np.random.default_rng(seed)
    if cfg is None:
        cfg, batch = draw_config(rng, cpu_smoke)
    elif batch is None:
        batch = 1
    h, w = cfg.in_shape
    img = rng.integers(0, 256, size=(batch, h, w, 3), dtype=np.uint8)
    if batch == 1:
        img = img[0]

    t0 = time.time()
    x = torch.from_numpy(img).to(device)
    dut = Upscaler(cfg, backend="pallas", device=device)
    got, kernels = _launched(lambda: dut(x))
    xla = Upscaler(cfg, backend="xla", device=device)(x).cpu().numpy()
    ref = _gather(img, cfg)
    tol, frac_lim = tolerance(cfg), frac_limit(cfg)
    on_card = x.device.type == "cuda"

    def passes(out, launched, md, fr):  # on the card a kernel must have run
        return out.shape == ref.shape and md <= tol and fr <= frac_lim and (
            bool(launched) or not on_card)

    # the same config as if no fused plan fit (kernel 2 for an integer
    # scale, else v1), where they take it: the fuzz's configs all have a
    # fused plan, and this is how they reach the other two kernels
    try:
        alt_ops = FusedOps(cfg, device, variant="v1")
    except NotImplementedError:
        no_plan, alt_ok = None, True
    else:
        alt, alt_kernels = _launched(lambda: resample_2d_cuda(x, alt_ops))
        md, fr = _diff(alt, ref)
        alt_ok = passes(alt, alt_kernels, md, fr)
        no_plan = {"route": alt_ops.variant, "kernels": alt_kernels, "max_diff": md,
                   "frac_diff": round(fr, 6), "ok": alt_ok}
    dt = time.time() - t0

    ops = dut._ops_for(x.device)
    route = "v1" if ops.phase is not None else "v2" if ops.shift is not None else "fused"
    max_diff, frac = _diff(got, ref)
    max_xla, frac_xla = _diff(got, xla)
    ok = bool(passes(got, kernels, max_diff, frac) and alt_ok)
    return {
        "seed": seed,
        "ok": ok,
        "scale": f"{cfg.scale_h[0]}/{cfg.scale_h[1]}",
        "in": list(cfg.in_shape),
        "out": list(cfg.out_shape),
        "a": cfg.a,
        "edge": cfg.edge_mode.value,
        "align": cfg.align.value,
        "order": cfg.order.value,
        "dering": cfg.dering,
        "quantize": cfg.intermediate_quantize,
        "normalize": cfg.normalize,
        "precision": cfg.precision.value,
        "batch": batch,
        "route": route,
        "mxu": any(k.startswith("fused_resample") for k in kernels) if on_card
        else route == "fused",
        "kernels": kernels,
        "max_diff": max_diff,
        "tol": tol,
        "frac_diff": round(frac, 6),
        "frac_lim": frac_lim,
        "max_diff_xla": max_xla,
        "frac_diff_xla": round(frac_xla, 6),
        "no_fused_plan": no_plan,
        "wall_s": round(dt, 2),
    }


def draw_exact(seed: int):
    """``(profile, cfg, image)`` of bit-exact seed ``seed``, as
    ``hwcert.py``'s ``run_seed_exact`` draws it."""
    from lanczos_torch.core.config import Profile, ResampleConfig

    rng = np.random.default_rng(EXACT_SEED0 + seed)
    profile = Profile.HLS if seed % 2 else Profile.C_ORACLE
    n, d = [(2, 1), (3, 1), (4, 1), (3, 2)][rng.integers(4)]
    a = 2 if profile == Profile.HLS else int(rng.integers(2, 4))
    h = int(rng.integers(6, 20)) * 8  # *8 keeps h, w divisible by d
    w = int(rng.integers(6, 20)) * 8
    cfg = ResampleConfig.from_profile(profile, (h, w), scale=(n, d), a=a)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return profile, cfg, img


def exact_oracle(profile: str, img: np.ndarray, out_shape: tuple, a: int,
                 bit_precision: int) -> np.ndarray:
    """The host oracle of a bit-exact profile (runs in a worker process)."""
    if profile == "hls":
        from lanczos_torch.ref.hls_sim import hls_stream_upscale

        return hls_stream_upscale(img, *out_shape, a, bit_precision)
    from lanczos_torch.ref.oracle import c_oracle_upscale

    return c_oracle_upscale(img, *out_shape, a)


def run_seed_exact(seed: int, device="cuda", oracle=None) -> dict:
    """Bit-exact profile certification: the ``hls`` / ``c_oracle`` paths on
    the device vs their host oracles (the stream-machine simulator and the
    fp64 oracle): equality, not tolerance.  ``oracle`` is the oracle's
    output when it was computed elsewhere (a worker process)."""
    import torch

    from lanczos_torch.models.upscaler import Upscaler

    profile, cfg, img = draw_exact(seed)
    (h, w), (n, d), a = cfg.in_shape, cfg.scale_h, cfg.a
    t0 = time.time()
    got = Upscaler(cfg, backend="auto", device=device)(
        torch.from_numpy(img).to(device)).cpu().numpy()
    want = oracle if oracle is not None else exact_oracle(
        profile.value, img, cfg.out_shape, a, cfg.bit_precision)
    dt = time.time() - t0
    exact = bool(np.array_equal(got, want))
    return {
        "seed": seed,
        "ok": exact,
        "profile": profile.value,
        "scale": f"{n}/{d}",
        "in": [h, w],
        "a": a,
        "exact": exact,
        "wall_s": round(dt, 2),
    }


def draw_aniso(seed: int, cpu_smoke: bool):
    """The config of anisotropic seed ``seed`` (distinct row and column
    scales), as ``hwcert.py``'s ``run_seed_aniso`` draws it."""
    from lanczos_torch.core.config import Align, EdgeMode, Profile, ResampleConfig

    rng = np.random.default_rng(ANISO_SEED0 + seed)
    n1, d1 = SCALES[rng.integers(len(SCALES))]
    n2, d2 = SCALES[rng.integers(len(SCALES))]
    while (n2, d2) == (n1, d1):
        n2, d2 = SCALES[rng.integers(len(SCALES))]
    lo, hi = (8, 14) if cpu_smoke else (12, 40)
    h = int(rng.integers(lo, hi)) * 8
    w = int(rng.integers(lo, hi)) * 8
    h -= h % (8 * d1)
    w -= w % (8 * d2)
    return ResampleConfig.from_profile(
        Profile.PRECISE, (h, w),
        out_shape=(h * n1 // d1, w * n2 // d2),
        a=int(rng.integers(2, 4)),
        edge_mode=EdgeMode(EDGES[rng.integers(len(EDGES))]),
        align=Align("center" if rng.integers(2) else "zero"),
        dering=bool(rng.integers(2)),
    )


def run_seed_aniso(seed: int, cpu_smoke: bool, device="cuda") -> dict:
    """Anisotropic in/out shapes through the fuzz seeds' contract."""
    cfg = draw_aniso(seed, cpu_smoke)
    row = run_seed(ANISO_SEED0 + seed, cpu_smoke, device, cfg=cfg, batch=1)
    row["kind"] = "aniso"
    row["scale"] = f"{cfg.scale_h[0]}/{cfg.scale_h[1]}x{cfg.scale_w[0]}/{cfg.scale_w[1]}"
    return row


def draw_u16(seed: int, cpu_smoke: bool):
    """``(cfg, image)`` of uint16 seed ``seed``, as ``hwcert.py``'s
    ``run_seed_u16`` draws them."""
    from lanczos_torch.core.config import Profile, ResampleConfig

    rng = np.random.default_rng(U16_SEED0 + seed)
    n, d = [(2, 1), (3, 1), (3, 2), (1, 2)][rng.integers(4)]
    lo, hi = (6, 12) if cpu_smoke else (8, 24)
    h = int(rng.integers(lo, hi)) * 8
    w = int(rng.integers(lo, hi)) * 8
    h -= h % (8 * d)
    w -= w % (8 * d)
    cfg = ResampleConfig.from_profile(
        Profile.PRECISE, (h, w), scale=(n, d), a=int(rng.integers(2, 4))
    )
    img = rng.integers(0, 65536, size=(h, w, 3), dtype=np.uint16)
    return cfg, img


def run_seed_u16(seed: int, cpu_smoke: bool, device="cuda") -> dict:
    """uint16 dtype contract: the device float path and trunc-clip at
    16-bit width (``auto``) vs the float64 gather: |Δ| ≤ 1 LSB of the
    16-bit range on ≤ 1% of pixels; the Δ from the port's ``xla`` gather
    beside it."""
    import torch

    from lanczos_torch.models.upscaler import Upscaler

    cfg, img = draw_u16(seed, cpu_smoke)
    (h, w), (n, d) = cfg.in_shape, cfg.scale_h
    t0 = time.time()
    x = torch.from_numpy(img).to(device)
    got = Upscaler(cfg, backend="auto", device=device)(x).cpu().numpy()
    xla = Upscaler(cfg, backend="xla", device=device)(x).cpu().numpy()
    ref = _gather(img, cfg)
    dt = time.time() - t0
    max_diff, frac = _diff(got, ref)
    max_xla, frac_xla = _diff(got, xla)
    ok = bool(got.dtype == np.uint16 and max_diff <= 1 and frac <= 0.01)
    return {
        "seed": U16_SEED0 + seed,
        "ok": ok,
        "kind": "uint16",
        "scale": f"{n}/{d}",
        "in": [h, w],
        "a": cfg.a,
        "max_diff": max_diff,
        "tol": 1,
        "frac_diff": round(frac, 6),
        "max_diff_xla": max_xla,
        "frac_diff_xla": round(frac_xla, 6),
        "wall_s": round(dt, 2),
    }


def run_y4m_cert(cpu_smoke: bool, colorspace: str = "420p10", device="cuda") -> dict:
    """Y4M end to end: a 24-frame clip through ``upscale_y4m`` on the
    device, every output plane against the float64 oracle
    ``clean_resample_2d`` (≤ 1 LSB of the stream's bit depth on ≤ 1%), the
    output bytes hashed into the report.  ``colorspace`` covers the
    subsampling × depth matrix (420p10 by default; 422p12, mono, ...)."""
    import hashlib
    import tempfile

    from lanczos_torch.core.config import Profile, ResampleConfig
    from lanczos_torch.io.y4m import _COLORSPACES, Y4MReader, _split_depth, write_y4m
    from lanczos_torch.models.video import upscale_y4m
    from lanczos_torch.ref.oracle import clean_resample_2d

    base, depth = _split_depth(colorspace)
    div = _COLORSPACES[base]
    lim = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16
    rng = np.random.default_rng(Y4M_SEED)
    h, w = (32, 48) if cpu_smoke else (48, 64)
    n_frames = 8 if cpu_smoke else 24

    def draw(shape):
        return rng.integers(0, lim + 1, shape, dt)

    frames = [
        (draw((h, w)),) + (
            # Cb and Cr are independent draws: identical planes would hide
            # a U/V swap or crosstalk
            (draw((h // div[0], w // div[1])),
             draw((h // div[0], w // div[1]))) if div else ()
        )
        for _ in range(n_frames)
    ]
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "s.y4m"), os.path.join(td, "o.y4m")
        write_y4m(src, frames, fps=(24, 1), colorspace=colorspace)
        upscale_y4m(src, dst, scale=(2, 1), a=3, batch=4, device=device)
        with open(dst, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        cfg_y = ResampleConfig.from_profile(Profile.PRECISE, (h, w), scale=(2, 1), a=3)
        cfg_c = ResampleConfig.from_profile(
            Profile.PRECISE, (h // div[0], w // div[1]), scale=(2, 1), a=3
        ) if div else None
        max_diff, ndiff, ntot = 0, 0, 0
        with Y4MReader(dst) as r:
            if r.header.colorspace != colorspace:
                raise ValueError(f"{colorspace}: the output says {r.header.colorspace}")
            for k, got in enumerate(r):
                for j, plane in enumerate(got):
                    cfg = cfg_y if j == 0 else cfg_c
                    src_p = frames[k][j].astype(np.float64)[..., None]
                    want = clean_resample_2d(src_p, cfg)[..., 0]
                    want = np.trunc(np.clip(want, 0, lim)).astype(plane.dtype)
                    d = np.abs(plane.astype(np.int64) - want.astype(np.int64))
                    max_diff = max(max_diff, int(d.max()))
                    ndiff += int((d > 0).sum())
                    ntot += d.size
    frac = ndiff / ntot
    return {
        "seed": Y4M_SEED,
        "ok": bool(max_diff <= 1 and frac <= 0.01),
        "kind": f"y4m_{colorspace}",
        "frames": n_frames,
        "in": [h, w],
        "sha256_16": digest,
        "max_diff": max_diff,
        "tol": 1,
        "frac_diff": round(frac, 6),
        "wall_s": round(time.time() - t0, 2),
    }


def nvidia_smi(query: str = "name,power.limit") -> str | None:
    """The first card's line of ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader`` (by default its name and power limit), or None
    where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def distribution(rows: list) -> dict:
    """By precision (``_quant`` with the quantized intermediate), the fuzz
    and aniso rows' ``max_diff`` counts and the spread of ``frac_diff``."""
    out = {}
    for r in rows:
        if "precision" not in r:
            continue
        key = r["precision"] + ("_quant" if r.get("quantize") else "")
        g = out.setdefault(key, {"rows": 0, "max_diff": {}, "frac": []})
        g["rows"] += 1
        g["max_diff"][str(r["max_diff"])] = g["max_diff"].get(str(r["max_diff"]), 0) + 1
        g["frac"].append(r["frac_diff"])
    for g in out.values():
        f = np.asarray(g.pop("frac"))
        g["frac_diff"] = {"min": float(f.min()), "median": float(np.median(f)),
                          "max": float(f.max())}
    return out


def summarize(rows: list, device_name: str, mode: str, wall_s: float) -> dict:
    fails = sum(0 if r["ok"] else 1 for r in rows)
    return {
        "summary": True,
        "device": device_name,
        "power_limit": nvidia_smi() if mode == "hardware" else None,
        "mode": mode,
        "seeds": len(rows),
        "passed": len(rows) - fails,
        "failed": fails,
        "mxu_configs": sum(1 for r in rows if r.get("mxu")),
        "exact_profiles": sum(1 for r in rows if "exact" in r),
        "aniso": sum(1 for r in rows if r.get("kind") == "aniso"),
        "uint16": sum(1 for r in rows if r.get("kind") == "uint16"),
        "y4m": sum(1 for r in rows if str(r.get("kind", "")).startswith("y4m")),
        "skipped": sum(1 for r in rows if r.get("skipped")),
        "no_fused_plan": {
            route: sum(1 for r in rows if (r.get("no_fused_plan") or {}).get("route") == route)
            for route in ("v2", "v1")
        },
        "by_precision": distribution(rows),
        "wall_s": round(wall_s, 2),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=40)
    p.add_argument("--exact-seeds", type=int, default=8,
                   help="bit-exact hls/c_oracle profile seeds (device vs "
                        "host oracle, equality)")
    p.add_argument("--aniso-seeds", type=int, default=6,
                   help="anisotropic (distinct row/col scale) seeds")
    p.add_argument("--u16-seeds", type=int, default=6,
                   help="uint16 dtype-contract seeds")
    p.add_argument("--y4m", type=int, default=1, choices=[0, 1],
                   help="run the Y4M end-to-end certifications "
                        "(--y4m-colorspaces)")
    p.add_argument("--y4m-colorspaces", default="420p10,422p12,mono",
                   help="comma list of Y4M colorspace tags to certify")
    p.add_argument("--seed0", type=int, default=0)
    p.add_argument("--cpu-smoke", action="store_true",
                   help="reduced sweep on the CPU (the plain versions) for "
                        "off-card testing")
    p.add_argument("--device", default="cuda",
                   help="device under test (default cuda; cpu runs the "
                        "plain versions at the full sizes)")
    p.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1),
                   help="processes that run the bit-exact seeds' host oracles")
    p.add_argument("--out", default=None, help="also write the report here")
    p.add_argument("--append", action="store_true",
                   help="keep the rows already in --out and write one "
                        "summary over them and this run's")
    args = p.parse_args(argv)

    import torch

    device = "cpu" if args.cpu_smoke else args.device
    if torch.device(device).type not in ("cuda", "cpu"):
        p.error(f"--device {device}: the port runs on cuda or cpu")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("hwcert needs a CUDA device (or pass --cpu-smoke or --device cpu)",
              file=sys.stderr)
        return 2
    on_card = torch.device(device).type == "cuda"
    mode = "hardware" if on_card else "cpu-smoke" if args.cpu_smoke else "cpu"
    name = torch.cuda.get_device_name(torch.device(device)) if on_card else "cpu"

    t_start, wall_before = time.time(), 0.0
    rows = []
    if args.append and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                row = json.loads(line)
                if row.get("summary"):
                    wall_before += row.get("wall_s", 0.0)
                else:
                    rows.append(row)
    sink = open(args.out, "w") if args.out else None
    try:
        for row in rows:
            sink.write(json.dumps(row) + "\n")

        def emit(row):
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if sink:  # a run cut short keeps the rows already certified
                sink.write(line + "\n")
                sink.flush()

        # the bit-exact seeds' oracles start first and run in worker
        # processes while the card certifies the fuzz seeds
        draws = [draw_exact(s) for s in range(args.exact_seeds)]
        with ProcessPoolExecutor(
            max(1, min(args.workers, len(draws))),
            mp_context=multiprocessing.get_context("spawn"),
        ) if draws else contextlib.nullcontext() as pool:
            oracles = [
                pool.submit(exact_oracle, prof.value, img, cfg.out_shape, cfg.a,
                            cfg.bit_precision)
                for prof, cfg, img in draws
            ]
            for seed in range(args.seed0, args.seed0 + args.seeds):
                emit(run_seed(seed, args.cpu_smoke, device))
            for seed, fut in enumerate(oracles):
                emit(run_seed_exact(seed, device, oracle=fut.result()))
        for seed in range(args.aniso_seeds):
            emit(run_seed_aniso(seed, args.cpu_smoke, device))
        for seed in range(args.u16_seeds):
            emit(run_seed_u16(seed, args.cpu_smoke, device))
        if args.y4m:
            for cs in args.y4m_colorspaces.split(","):
                emit(run_y4m_cert(args.cpu_smoke, cs.strip(), device))
        summary = summarize(rows, name, mode, wall_before + time.time() - t_start)
        print(json.dumps(summary), flush=True)
        if sink:
            sink.write(json.dumps(summary) + "\n")
    finally:
        if sink:
            sink.close()
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
