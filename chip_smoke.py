"""Smoke test of the PyTorch/CUDA port (``lanczos_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing as it goes; any failure raises and the exit code is
not 0:

1. environment: a CUDA device is required (no CPU fallback); prints the
   card's name and power limit from ``nvidia-smi`` and the versions;
2. build: compiles ``lanczos_torch/csrc`` with ``nvcc`` and loads it;
3. each kernel against its plain PyTorch version on the card, at small
   shapes: the fused kernel linear (ragged tiles and blocks, a rational
   scale, center alignment, a batch, a shared-memory-heavy downscale),
   with dering (clamp, reflect and drop edges, rational, width first),
   with the quantized intermediate and with both, fp32 and bf16; kernel 2
   (v2) at 2/1, 3/1, center-aligned and reflect, dering on and off; the
   v1 kernel (3/2, 2/3, 1/16, mixed integer and rational axes, reflect,
   drop) and every ablation kernel of the fused kernel, fp32 and bf16;
4. the main path: ``lanczos_torch.upscale(img, scale=(2, 1),
   profile="precise", a=3)`` on a seeded 2160×3840×3 uint8 frame in fp32
   and bf16, with the kernel's launch counts, held against a float64
   numpy separable gather and against the plain version;
5. times of the kernel and the plain version at 4K→8K (CUDA events);
6. the dering path at full width, on the same frame: ``upscale(...,
   dering=True)`` in fp32 and bf16, ``intermediate_quantize=True`` (and
   with dering), ``order="width_first", dering=True``, and kernel 2 through
   ``FusedOps(cfg, "cuda", variant="v2")``; each run with its own launch
   counts, held against its plain version and against float64 gathers
   with the clamp, the quantize and the pass order;
7. times of every new kernel and its plain version at 4K→8K;
8. the v1 path at full width, fp32 and bf16, each run with its own launch
   counts: a Lanczos-3 thumbnail of an 8K frame (4320×7680×3 → 270×480×3,
   no fused plan) through ``upscale(..., backend="pallas")``, FSR's
   "Quality" 1440p→4K (3/2) and a 4/3 anamorphic desqueeze (2160×2880 →
   2160×3840) through ``FusedOps(variant="v1")``; each against its plain
   version and a float64 gather;
9. times of the v1 kernel and its plain version on those three;
10. the fused kernel's ablation harness (``lanczos_torch.tools.ablate_fused``)
   over every variant at 4K→8K, 12 planes: each against its plain version
   and the production kernel's bytes, and timed beside it;
11. the bit-exact profiles on the card: ``hls`` and ``c_oracle`` at small
   seeds drawn as ``hwcert.py`` draws its exact seeds (plus ``hls`` at
   P = 6 and 10), each byte-equal to its ``lanczos_torch.ref`` oracle (run
   in worker processes meanwhile); at 4K→8K, ``c_oracle`` a=3 byte-equal
   to ``c_oracle_upscale`` and ``hls`` a=2 byte-equal to the same module's
   run on the host CPU;
12. the float paths at full width, each against a float64 gather:
   ``backend="xla"`` uint8 fp32 and bf16 at 4K→8K; float32 and uint16
   input at 4K→8K through ``auto`` (the strided path); float32 1080×1920 →
   1126×2001 through ``auto`` (the block path), also with TF32 enabled,
   which must not change a byte;
13. times of every new path at full width through ``Upscaler``, beside the
   fused kernel on the same 4K→8K frame.

Limits: fp32 ≤ 1 LSB on ≤ 1% of pixels (the quantized intermediate ≤ 2
LSB: one flipped intermediate value spreads over the taps); bf16 ≤ 3 LSB
on ≤ 50% of pixels; kernel 2, the v1 kernel and the ablation kernels and
their plain versions identical bytes; the bit-exact profiles identical
bytes; float output |Δ| ≤ 1e-3 (values 0–255).  The last lines are one
JSON object of the kernels and one of the device.
"""

from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50), "quant": (2, 0.01), "exact": (0, 0.0),
          "float": (1e-3, 1.0)}
FRAME = (2160, 3840)  # the main path's input, 4K; output 2x each way
# a rational scale (563/540 by 667/640) only the block path takes
BLOCK_CASE = ((1080, 1920), (1126, 2001))
FP32_PEAK_TFLOPS = 67.0  # H100 SXM, SIMT fp32, NVIDIA's data sheet at 700 W
T0 = time.perf_counter()


def compare(name: str, got, want, precision: str) -> tuple[int, float]:
    """Max |Δ| and the share of differing pixels; raises past the limits."""
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    want = want.detach().cpu().numpy() if hasattr(want, "detach") else want
    floats = precision == "float"  # float32 output against float64
    if got.shape != want.shape or (
        got.dtype != want.dtype if not floats else got.dtype != np.float32
    ):
        raise AssertionError(
            f"{name}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}"
        )
    d = np.abs(got.astype(np.float64 if floats else np.int64) - want)
    mx, frac = (float if floats else int)(d.max()), float((d > 0).mean())
    lim, frac_lim = LIMITS[precision]
    ok = mx <= lim and frac <= frac_lim
    print(f"  {name}: max|d|={mx:g} differing={frac:.6f} "
          f"(limit {lim} on {frac_lim}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} outside the {precision} limits")
    return mx, frac


def gather_f64(img: np.ndarray, cfg) -> np.ndarray:
    """Float64 separable gather from the port's banded_weights: the
    (H, W, C) reference of a precise config, in its pass order, with its
    dering clamp (each pass to its two central taps) and its quantized
    intermediate; trunc-clipped to the input's integer type (uint8 or
    uint16), float64 for float input."""
    from lanczos_torch.core.weights import banded_weights

    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    kw = dict(a=cfg.a, filter_name=cfg.filter, edge_mode=cfg.edge_mode,
              normalize=cfg.normalize, align=cfg.align.value)
    op_v, op_h = banded_weights(ih, oh, **kw), banded_weights(iw, ow, **kw)

    def apply(x, op, axis):
        shape = [1, 1, 1]
        shape[axis] = op.out_size
        acc = None
        for j in range(op.taps):
            term = op.weights[:, j].reshape(shape) * np.take(x, op.idx[:, j], axis)
            acc = term if acc is None else np.add(acc, term, out=acc)
        if cfg.dering:
            c0 = np.take(x, op.idx[:, op.a - 1], axis)
            c1 = np.take(x, op.idx[:, op.a], axis)
            acc = np.clip(acc, np.minimum(c0, c1), np.maximum(c0, c1))
        return acc

    first, second = ((op_v, 0), (op_h, 1))
    if cfg.order.value == "width_first":
        first, second = second, first
    mid = apply(img.astype(np.float64), *first)
    if cfg.intermediate_quantize:
        # Exactly integral intermediates (at 2/1 the even rows copy the
        # input) come out of float64 a few ulps to either side, because
        # sin(pi*k) leaves the zero taps at ~1e-17; truncation would drop
        # those below by a whole level.  Snap them to the integer first.
        near = np.round(mid)
        mid = np.where(np.abs(mid - near) < 1e-9, near, mid)
        mid = np.trunc(np.clip(mid, 0.0, 255.0))
    out = apply(mid, *second)
    if img.dtype.kind == "f":
        return out
    top = float(np.iinfo(img.dtype).max)
    return np.trunc(np.clip(out, 0.0, top)).astype(img.dtype)


def plain_version(x, ops):
    """The plain PyTorch version of whatever kernel ``ops`` runs, on the
    planar (NC, H, W) uint8 ``x``, on ``x``'s device."""
    from lanczos_torch.ops import resample_phase_cuda as rp
    from lanczos_torch.ops import resample_shift_cuda as rs
    from lanczos_torch.ops.resample_cuda import fused_resample_reference

    if ops.tr_ops is not None:
        return plain_version(x.transpose(-1, -2).contiguous(), ops.tr_ops).transpose(-1, -2)
    cfg = ops.cfg
    if ops.phase is not None:
        return rp.phase_resample_reference(x, ops.phase.plan, cfg.precision, cfg.out_shape)
    if ops.shift is not None:
        return rs.shift_resample_reference(x, ops.shift.plan, cfg.out_shape, cfg.dering)
    return fused_resample_reference(x, ops.plan, cfg.precision, cfg.out_shape,
                                    cfg.dering, cfg.intermediate_quantize)


def limits(cfg, variant: str) -> str:
    """Which LIMITS a run of ``cfg`` on ``variant`` is held to."""
    if variant == "v2":
        return "fp32"  # v2 computes in fp32 whatever the precision
    if cfg.precision.value == "bf16":
        return "bf16"
    return "quant" if cfg.intermediate_quantize else "fp32"


def _counters() -> tuple:
    from lanczos_torch.ops import resample_cuda as rc, resample_phase_cuda as rp
    from lanczos_torch.ops import resample_shift_cuda as rs
    from lanczos_torch.tools import ablate_fused as af

    return rc.launches, rs.launches, rp.launches, af.launches


def reset_counts() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return {k: n for counts in _counters() for k, n in counts.items() if n}


def dense_flops(plan, nc: int) -> float:
    """Flops of the kernel's dense products over one call (padding included)."""
    r8 = lambda v, m: -(-v // m) * m  # noqa: E731
    tile_p, kh_p, cb_p = r8(plan.tile_out, 8), r8(plan.kh, 8), r8(plan.cb, 4)
    per_block = kh_p * tile_p * plan.kv + tile_p * cb_p * plan.kh
    return 2.0 * nc * plan.num_tiles * plan.n_cb * per_block


def _plan_with(cfg, tile: int, cb: int):
    """A plan at given tile and block targets (the generic-shape cases)."""
    from lanczos_torch.ops.resample_cuda import plan_at

    plan = plan_at(cfg, tile, cb)
    if plan is None:
        raise AssertionError(f"no plan at tile {tile}, cb {cb} for {cfg}")
    return plan


def exact_seeds() -> list:
    """``(name, profile, shape, scale, a, bit_precision, image)`` of the
    bit-exact seeds, drawn as ``hwcert.py``'s ``run_seed_exact`` draws
    them (odd seeds ``hls``, even ``c_oracle``), plus two ``hls`` seeds at
    P = 6 and P = 10."""
    out = []
    for seed, bp in [(s, 8) for s in range(10)] + [(11, 6), (13, 10)]:
        rng = np.random.default_rng(10_000 + seed)
        profile = "hls" if seed % 2 else "c_oracle"
        n, d = [(2, 1), (3, 1), (4, 1), (3, 2)][rng.integers(4)]
        a = 2 if profile == "hls" else int(rng.integers(2, 4))
        h = int(rng.integers(6, 20)) * 8  # *8 keeps h, w divisible by d
        w = int(rng.integers(6, 20)) * 8
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        name = f"{profile} seed {seed} {h}x{w} {n}/{d} a={a}" + (
            f" P={bp}" if profile == "hls" else "")
        out.append((name, profile, (h, w), (n, d), a, bp, img))
    return out


def exact_oracle(profile: str, img: np.ndarray, out: tuple, a: int, bp: int) -> np.ndarray:
    """The host oracle of a bit-exact profile (runs in a worker process)."""
    if profile == "hls":
        from lanczos_torch.ref.hls_sim import hls_stream_upscale

        return hls_stream_upscale(img, out[0], out[1], a, bp)
    from lanczos_torch.ref.oracle import c_oracle_upscale

    return c_oracle_upscale(img, out[0], out[1], a)


def bit_exact_and_float_paths(img: np.ndarray, x, smi: str) -> None:
    """Phases 11–13: the bit-exact profiles, the float paths and their
    times, on ``x`` (``img`` on the card)."""
    import torch

    import lanczos_torch
    from lanczos_torch.utils.timing import cuda_time_ms

    # ---- 11. the bit-exact profiles
    print("== 11. bit-exact profiles on the card vs the host oracles", flush=True)
    from lanczos_torch.models.upscaler import Upscaler, _shift_eligible
    from lanczos_torch.ref._native import native_lib
    from lanczos_torch.ref.oracle import c_oracle_upscale

    print(f"  c_oracle_upscale's height pass runs its "
          f"{'C' if native_lib() is not None else 'NumPy'} loop", flush=True)
    seeds = exact_seeds()
    big_out = (2 * FRAME[0], 2 * FRAME[1])
    cfg_c = lanczos_torch.ResampleConfig.from_profile("c_oracle", FRAME, scale=(2, 1), a=3)
    cfg_h = lanczos_torch.ResampleConfig.from_profile("hls", FRAME, scale=(2, 1), a=2)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as procs, \
            ThreadPoolExecutor(2) as threads:
        refs = [
            procs.submit(exact_oracle, prof, im, (sh[0] * sc[0] // sc[1], sh[1] * sc[0] // sc[1]),
                         a, bp)
            for _, prof, sh, sc, a, bp, im in seeds
        ]
        big_c = threads.submit(c_oracle_upscale, img, *big_out, 3)
        big_h = threads.submit(
            lambda: Upscaler(cfg_h, device="cpu")(torch.from_numpy(img)).numpy())
        for (name, prof, sh, sc, a, bp, im), ref in zip(seeds, refs):
            cfg = lanczos_torch.ResampleConfig.from_profile(
                prof, sh, scale=sc, a=a, bit_precision=bp)
            up = Upscaler(cfg)
            y = up(torch.from_numpy(im).to(x.device))
            if y.device != x.device or y.dtype != torch.uint8:
                raise AssertionError(f"{name}: got {y.dtype} on {y.device}")
            compare(f"{name} ({up.path}) vs {'hls_sim' if prof == 'hls' else 'c_oracle'}",
                    y, ref.result(), "exact")
        for name, cfg, ref in (("c_oracle a=3", cfg_c, big_c),
                               ("hls a=2", cfg_h, big_h)):
            torch.cuda.reset_peak_memory_stats()
            up = Upscaler(cfg)
            y = up(x)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            if y.shape != (*big_out, 3) or y.dtype != torch.uint8 or y.device != x.device:
                raise AssertionError(f"{name}: got {tuple(y.shape)} {y.dtype} {y.device}")
            want = "c_oracle_upscale" if cfg.c_faithful else "the same module on the host CPU"
            compare(f"{name} 4K->8K ({up.path}, peak {peak:.2f} GiB) vs {want}", y,
                    ref.result(), "exact")
            del y
    print(f"  host oracles (worker processes and threads): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- 12. the float paths at full width
    print("== 12. float paths at full width vs float64 gathers", flush=True)
    rng12 = np.random.default_rng(12)
    img_f = (rng12.random(FRAME + (3,), dtype=np.float32) * 255).astype(np.float32)
    img_16 = rng12.integers(0, 65536, FRAME + (3,), dtype=np.uint16)
    img_1080 = (rng12.random(BLOCK_CASE[0] + (3,), dtype=np.float32) * 255).astype(np.float32)
    paths12 = [  # name, input, overrides, backend, limits, reference key
        ("xla fp32 uint8 4K->8K", img, dict(scale=(2, 1)), "xla", "fp32", "u8"),
        ("xla bf16 uint8 4K->8K", img, dict(scale=(2, 1), precision="bf16"), "xla", "bf16",
         "u8"),
        ("float32 4K->8K", img_f, dict(scale=(2, 1)), "auto", "float", "f32"),
        ("uint16 4K->8K", img_16, dict(scale=(2, 1)), "auto", "fp32", "u16"),
        ("float32 1080x1920->1126x2001", img_1080, dict(out_shape=BLOCK_CASE[1]), "auto",
         "float", "f1080"),
    ]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as threads:
        refs = {}
        for _, im, kw, _, _, key in paths12:
            if key not in refs:  # one fp32 reference serves fp32 and bf16
                kw = {k: v for k, v in kw.items() if k != "precision"}
                refs[key] = threads.submit(gather_f64, im, lanczos_torch.ResampleConfig
                                           .from_profile("precise", im.shape[:2], a=3, **kw))
        timed = []
        for name, im, kw, backend, lim, key in paths12:
            cfg = lanczos_torch.ResampleConfig.from_profile("precise", im.shape[:2], a=3, **kw)
            up = Upscaler(cfg, backend=backend)
            took = up.path if up.path != "cuda" or im.dtype == np.uint8 else (
                "shift_xla" if _shift_eligible(cfg) else "block")
            xin = torch.from_numpy(im).to(x.device)
            y = up(xin)
            torch.cuda.synchronize()
            want_dt = torch.float32 if im.dtype.kind == "f" else getattr(torch, im.dtype.name)
            if y.device != x.device or y.dtype != want_dt:
                raise AssertionError(f"{name}: got {y.dtype} on {y.device}")
            compare(f"{name} (backend {backend!r} took {took}) vs float64 gather", y,
                    refs[key].result(), lim)
            if took == "block":
                # TF32 on: the block path's fp32 products are float64 contractions
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    y32 = up(xin)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                if not torch.equal(y32, y):
                    raise AssertionError(f"{name}: TF32 changed the block path's bytes")
                print(f"  {name}: identical with TF32 enabled", flush=True)
                del y32
            timed.append((name, up, xin, took))
            del y
    print(f"  float64 numpy gather references (4, in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 13. times of the new paths
    print("== 13. times of the new paths at full width through Upscaler (CUDA events, "
          f"mean of 20 after 3 warm-up) [{smi}]", flush=True)
    u8 = [("fused kernel fp32 (auto)", dict(), "auto"),
          ("fused kernel bf16 (auto)", dict(precision="bf16"), "auto"),
          ("shift_xla fp32 uint8", dict(), "shift_xla"),
          ("block fp32 uint8", dict(), "block"),
          ("block bf16 uint8", dict(precision="bf16"), "block")]
    timed = [
        (f"{name} 4K->8K", up, x, up.path)
        for name, kw, backend in u8
        for up in [Upscaler(lanczos_torch.ResampleConfig.from_profile(
            "precise", FRAME, scale=(2, 1), a=3, **kw), backend)]
    ] + timed + [("c_oracle a=3 4K->8K", Upscaler(cfg_c), x, "c_exact"),
                 ("hls a=2 4K->8K", Upscaler(cfg_h), x, "hls")]
    for name, up, xin, took in timed:
        ms = cuda_time_ms(up, xin)
        print(f"  {name} ({took}): {ms:.4f} ms/frame", flush=True)
        torch.cuda.empty_cache()
    del timed


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
    nonlinear = [  # name, (h, w), scale, batch, overrides
        ("dering 2/1 clamp 60x80", (60, 80), (2, 1), 1, {"dering": True}),
        ("dering 3/1 reflect 60x80", (60, 80), (3, 1), 1,
         {"dering": True, "edge_mode": "reflect"}),
        ("dering 3/2 rational 60x80", (60, 80), (3, 2), 1, {"dering": True}),
        ("drop-edge dering 3/2 48x64", (48, 64), (3, 2), 1,
         {"dering": True, "edge_mode": "drop", "normalize": False}),
        ("drop-edge dering 3/2 normalized 48x64", (48, 64), (3, 2), 1,
         {"dering": True, "edge_mode": "drop"}),
        ("quantize 2/1 48x64", (48, 64), (2, 1), 1, {"intermediate_quantize": True}),
        ("dering+quantize 2/1 48x64", (48, 64), (2, 1), 1,
         {"dering": True, "intermediate_quantize": True}),
        ("width-first dering 3/2 40x56", (40, 56), (3, 2), 1,
         {"dering": True, "order": "width_first"}),
        ("dering ragged tile+block 100x300", (100, 300), (2, 1), 1, {"dering": True}),
        ("dering batch-2 planar 64x96", (64, 96), (2, 1), 2, {"dering": True}),
    ]
    for precision in ("fp32", "bf16"):
        for name, (h, w), scale, batch, kw in nonlinear:
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", (h, w), scale=scale, a=3, precision=precision, **kw
            )
            ops = rc.FusedOps(cfg, "cuda")
            x = torch.from_numpy(
                rng.integers(0, 256, (batch * 3, h, w), dtype=np.uint8)
            ).cuda()
            got = rc.upscale_planar(x, ops)
            want = plain_version(x, ops)
            torch.cuda.synchronize()
            compare(f"{ops.kernel} {name}", got, want, limits(cfg, ops.variant))
    v2_cases = [  # name, (h, w), scale, overrides
        ("2/1 24x40", (24, 40), (2, 1), {}),
        ("3/1 24x40", (24, 40), (3, 1), {}),
        ("2/1 align=center 24x40", (24, 40), (2, 1), {"align": "center"}),
        ("2/1 reflect 24x40", (24, 40), (2, 1), {"edge_mode": "reflect"}),
    ]
    for dering in (True, False):
        for name, (h, w), scale, kw in v2_cases:
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", (h, w), scale=scale, a=3, dering=dering, **kw
            )
            ops = rc.FusedOps(cfg, "cuda", variant="v2")
            x = torch.from_numpy(rng.integers(0, 256, (3, h, w), dtype=np.uint8)).cuda()
            got = rc.upscale_planar(x, ops)
            want = plain_version(x, ops)
            torch.cuda.synchronize()
            compare(f"{ops.kernel} {name}{' dering' if dering else ''}", got, want,
                    "exact")
    v1_cases = [  # name, (h, w), out, overrides
        ("3/2 24x40", (24, 40), (36, 60), {}),
        ("2/3 align=center 36x60", (36, 60), (24, 40), {"align": "center"}),
        ("1/16 256x256 (support 48)", (256, 256), (16, 16), {}),
        ("1/16 384x384 (no fused plan, tile shrinks)", (384, 384), (24, 24), {}),
        ("2/1 by 3/2 reflect 24x40", (24, 40), (48, 60), {"edge_mode": "reflect"}),
        ("3/2 by 1/1 drop 24x40", (24, 40), (36, 40),
         {"edge_mode": "drop", "normalize": False}),
        ("1/16 reflect 32x48 (support > image)", (32, 48), (2, 3), {"edge_mode": "reflect"}),
    ]
    for precision in ("fp32", "bf16"):
        for name, (h, w), out, kw in v1_cases:
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", (h, w), out_shape=out, a=3, precision=precision, **kw
            )
            ops = rc.FusedOps(cfg, "cuda", variant="v1")
            x = torch.from_numpy(rng.integers(0, 256, (3, h, w), dtype=np.uint8)).cuda()
            got = rc.upscale_planar(x, ops)
            want = plain_version(x, ops)
            torch.cuda.synchronize()
            compare(f"{precision} {ops.kernel} {name}", got, want, "exact")
    from lanczos_torch.tools import ablate_fused as af

    for precision in ("fp32", "bf16"):
        for (h, w), out, tile, cb in (((36, 64), (72, 128), 16, 32),
                                      ((50, 92), (100, 184), 8, 32)):
            cfg = af.frame_cfg(lanczos_torch.Precision(precision), (h, w), out)
            ops = rc.FusedOps(cfg, "cuda", _plan_with(cfg, tile, cb))
            x = torch.from_numpy(rng.integers(0, 256, (3, h, w), dtype=np.uint8)).cuda()
            for stage in af.STAGES:
                got = af.ablate_call(ops, x, stage)
                want = af.ablation_reference(x, ops.plan, cfg.precision, stage, out)
                torch.cuda.synchronize()
                variant = ("f32" if precision == "fp32" else "") + stage
                compare(f"ablate_fused_{variant} {h}x{w}->{out[0]}x{out[1]}", got, want,
                        "exact")

    # ---- 4. main path
    print("== 4. main path: upscale 2160x3840x3 -> 4320x7680x3, a=3, precise",
          flush=True)
    img = np.random.default_rng(0).integers(0, 256, FRAME + (3,), dtype=np.uint8)
    out_shape = (2 * FRAME[0], 2 * FRAME[1], 3)
    x = torch.from_numpy(img).cuda()
    torch.cuda.synchronize()
    reset_counts()
    outs = {
        "fp32": lanczos_torch.upscale(x, scale=(2, 1), profile="precise", a=3),
        "bf16": lanczos_torch.upscale(
            x, scale=(2, 1), profile="precise", a=3, precision="bf16"
        ),
    }
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"  launches during the main path: {counts}", flush=True)
    for k in ("fused_resample_fp32", "fused_resample_bf16"):
        if counts.get(k, 0) < 1:
            raise AssertionError(f"kernel {k} was not launched by the main path")
    cfgs = {
        p: lanczos_torch.ResampleConfig.from_profile(
            "precise", FRAME, scale=(2, 1), a=3, precision=p
        )
        for p in outs
    }
    for p, y in outs.items():
        if tuple(y.shape) != out_shape or y.dtype != torch.uint8 or not y.is_cuda:
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

    # ---- 6. the dering path at full width
    print("== 6. dering and quantized-intermediate paths at 4K->8K", flush=True)
    from lanczos_torch.ops import resample_shift_cuda as rs

    def cfg_of(**kw):
        return lanczos_torch.ResampleConfig.from_profile(
            "precise", FRAME, scale=(2, 1), a=3, **kw
        )

    f64 = {  # float64 references, computed on host threads while the card runs
        "dering": cfg_of(dering=True),
        "quantize": cfg_of(intermediate_quantize=True),
        "width-first dering": cfg_of(dering=True, order="width_first"),
    }
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(f64))
    f64 = {k: (c, pool.submit(gather_f64, img, c)) for k, c in f64.items()}
    paths = [  # name, overrides, float64 reference, via (upscale or v2)
        ("fp32 dering", dict(dering=True), "dering", "upscale"),
        ("bf16 dering", dict(dering=True, precision="bf16"), "dering", "upscale"),
        ("fp32 quantize", dict(intermediate_quantize=True), "quantize", "upscale"),
        ("bf16 quantize", dict(intermediate_quantize=True, precision="bf16"),
         "quantize", "upscale"),
        ("fp32 dering+quantize", dict(dering=True, intermediate_quantize=True), None,
         "upscale"),
        ("bf16 dering+quantize",
         dict(dering=True, intermediate_quantize=True, precision="bf16"), None, "upscale"),
        ("fp32 width-first dering", dict(dering=True, order="width_first"),
         "width-first dering", "upscale"),
        ("v2 dering", dict(dering=True), "dering", "v2"),
    ]
    runs = {}
    for name, kw, ref, via in paths:
        cfg = cfg_of(**kw)
        ops = rc.FusedOps(cfg, "cuda", variant="v2" if via == "v2" else "auto")
        torch.cuda.synchronize()
        reset_counts()
        if via == "v2":
            y = rc.resample_2d_cuda(x, ops)
        else:
            y = lanczos_torch.upscale(x, scale=(2, 1), profile="precise", a=3, **kw)
        torch.cuda.synchronize()
        n = read_counts()
        print(f"  {name}: launches {n}", flush=True)
        if n.get(ops.kernel, 0) < 1:
            raise AssertionError(f"{name}: kernel {ops.kernel} was not launched")
        if tuple(y.shape) != out_shape or y.dtype != torch.uint8 or not y.is_cuda:
            raise AssertionError(f"{name}: got {tuple(y.shape)} {y.dtype} {y.device}")
        want = plain_version(planar, ops).permute(1, 2, 0)
        lim = "exact" if via == "v2" else limits(cfg, ops.variant)
        err, _ = compare(f"{name} ({ops.kernel}) vs plain version", y, want, lim)
        runs[name] = (cfg, ops, y.cpu().numpy(), ref, n[ops.kernel], err)
        del y, want
    for name, (cfg, ops, y, ref, _, _) in runs.items():
        if ref is not None:
            compare(f"{name} vs float64 gather", y, f64[ref][1].result(),
                    limits(cfg, ops.variant))
    print(f"  float64 numpy gather references (3, in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pool.shutdown()
    del f64
    torch.cuda.empty_cache()

    # ---- 7. times of the new kernels
    print("== 7. new kernels' times at 4K->8K (3 planes, CUDA events, mean of 20 "
          "after 3 warm-up; order plain, kernel, kernel, plain)", flush=True)
    for name, (cfg, ops, _, _, launched, err) in runs.items():
        if name == "fp32 width-first dering":
            # the fp32 dering kernel again, with a transposing copy each way
            def kernel_fn():
                return rc.upscale_planar(planar, ops)
        elif ops.shift is not None:
            def kernel_fn():
                return rs.shift_call(ops.shift, planar)
        else:
            def kernel_fn():
                return rc.fused_call(ops, planar)

        def plain_fn():
            return plain_version(planar, ops)

        t = [cuda_time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
        plain_ms, kernel_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"  {name} ({ops.kernel}): kernel {t[1]:.4f} / {t[2]:.4f} ms/frame, "
              f"plain version {t[0]:.4f} / {t[3]:.4f} ms/frame [{smi}]", flush=True)
        if name == "fp32 width-first dering":
            continue  # a path, not a kernel of its own
        kernels.append({
            "name": ops.kernel,
            "route": "cuda",
            "source": "lanczos_torch/csrc/" + (
                "shift_resample.cu" if ops.shift is not None else "fused_resample.cu"
            ),
            "replaces": "lanczos_tpu/ops/resample_pallas.py:" + (
                "779" if ops.shift is not None else "849"
            ),
            "launches": launched,
            "max_abs_err": err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        })

    del runs
    torch.cuda.empty_cache()

    # ---- 8. v1 at full width
    print("== 8. v1 at full width, 3 planes, fp32 and bf16", flush=True)
    v1_paths = [  # name, in, out, via: upscale(backend="pallas") or FusedOps(variant="v1")
        ("8K->480x270 thumbnail (1/16)", (4320, 7680), (270, 480), "pallas"),
        ("1440p->4K, FSR Quality (3/2)", (1440, 2560), (2160, 3840), "v1"),
        ("2160x2880->4K desqueeze (1/1 by 4/3)", (2160, 2880), (2160, 3840), "v1"),
    ]
    pool = ThreadPoolExecutor(len(v1_paths))
    t0 = time.perf_counter()
    v1_runs = []
    for name, shp, out, via in v1_paths:
        img_np = np.random.default_rng(0).integers(0, 256, shp + (3,), dtype=np.uint8)
        ref = pool.submit(gather_f64, img_np, lanczos_torch.ResampleConfig.from_profile(
            "precise", shp, out_shape=out, a=3))
        xin = torch.from_numpy(img_np).cuda()
        planar_in = xin.permute(2, 0, 1).contiguous()
        for p in ("fp32", "bf16"):
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", shp, out_shape=out, a=3, precision=p
            )
            variant = rc.pallas_variant(cfg) if via == "pallas" else "v1"
            ops = rc.FusedOps(cfg, "cuda", variant=variant)
            if ops.variant != "v1" or ops.plan is not None:
                raise AssertionError(f"{name}: runs {ops.kernel}, not v1")
            torch.cuda.synchronize()
            reset_counts()
            if via == "pallas":
                y = lanczos_torch.upscale(xin, out_shape=out, a=3, precision=p,
                                          backend="pallas")
            else:
                y = rc.resample_2d_cuda(xin, ops)
            torch.cuda.synchronize()
            n = read_counts()
            print(f"  {p} {name} ({ops.kernel}, tiles {ops.phase.tiles}): launches {n}",
                  flush=True)
            if n != {ops.kernel: 1}:
                raise AssertionError(f"{name}: expected one launch of {ops.kernel}, got {n}")
            if tuple(y.shape) != out + (3,) or y.dtype != torch.uint8 or not y.is_cuda:
                raise AssertionError(f"{name}: got {tuple(y.shape)} {y.dtype} {y.device}")
            want = plain_version(planar_in, ops).permute(1, 2, 0)
            err, _ = compare(f"{p} {name} vs plain version", y, want, "exact")
            v1_runs.append((name, p, ops, planar_in, y.cpu().numpy(), ref, err))
            del y, want
    for name, p, ops, _, y, ref, _ in v1_runs:
        compare(f"{p} {name} vs float64 gather", y, ref.result(), p)
    print(f"  float64 numpy gather references (3, in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pool.shutdown()
    torch.cuda.empty_cache()

    # ---- 9. v1 times
    print("== 9. v1 times (3 planes, CUDA events, mean of 20 after 3 warm-up; order "
          "plain, kernel, kernel, plain)", flush=True)
    v1_entries = {}
    for name, p, ops, planar_in, _, _, err in v1_runs:
        def kernel_fn():
            return rc.upscale_planar(planar_in, ops)

        def plain_fn():
            return plain_version(planar_in, ops)

        t = [cuda_time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
        print(f"  {p} {name} ({ops.kernel}): kernel {t[1]:.4f} / {t[2]:.4f} ms/frame, "
              f"plain version {t[0]:.4f} / {t[3]:.4f} ms/frame [{smi}]", flush=True)
        entry = v1_entries.setdefault(ops.kernel, {
            "name": ops.kernel,
            "route": "cuda",
            "source": "lanczos_torch/csrc/phase_resample.cu",
            "replaces": "lanczos_tpu/ops/resample_pallas.py:687",
            "launches": 0,
            "max_abs_err": 0,
            # the times of the thumbnail, the path that only v1 takes
            "ms": (t[1] + t[2]) / 2,
            "plain_ms": (t[0] + t[3]) / 2,
        })
        entry["launches"] += 1
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    kernels += list(v1_entries.values())
    del v1_runs
    torch.cuda.empty_cache()

    # ---- 10. the ablation harness
    print("== 10. the fused kernel's ablation harness: 12 planes 2160x3840 -> 4320x7680, "
          f"tile 64, every variant; ms per 3-plane frame [{smi}]", flush=True)
    specs = [af.parse_spec(f"64:{v}") for v in af.VARIANTS]
    himg = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (af.PLANES,) + FRAME, dtype=np.uint8)).cuda()
    torch.cuda.synchronize()
    reset_counts()
    results = af.run(specs, himg, log=lambda line: print("  " + line, flush=True))
    torch.cuda.synchronize()
    n = read_counts()
    for r in results:
        name = f"ablate_fused_{r['variant']}"
        if not r["ok"] or (r["variant"] in ("full", "f32full") and not r["same"]):
            raise AssertionError(f"{r['spec']}: bytes differ where they must not")
        if n.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched by the harness")
        stage = r["variant"].removeprefix("f32")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "lanczos_torch/csrc/ablate_fused.cu",
            "replaces": "tools/ablate_mxu.py:" + ("289" if stage == "swpipe" else "37"),
            "launches": n[name],
            "max_abs_err": r["plain_max_abs_diff"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
        })
    del himg

    bit_exact_and_float_paths(img, x, smi)

    print(f"  chip_smoke took {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
