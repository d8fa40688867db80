"""Smoke test of the PyTorch/CUDA port (``lanczos_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing as it goes; any failure raises and the exit code is
not 0:

1. environment: a CUDA device is required (no CPU fallback); prints the
   card's name and power limit from ``nvidia-smi`` and the versions;
2. build: compiles ``lanczos_torch/csrc`` with ``nvcc`` and loads it;
3. each kernel against its plain PyTorch version on the card, at small
   shapes: the fused kernel linear (ragged tiles and blocks, a rational
   scale, center alignment, a batch, a long-windowed downscale, widths
   that break its 16-byte loads and stores, a one-tile image),
   with dering (clamp, reflect and drop edges, rational, width first),
   with the quantized intermediate and with both, fp32 and bf16; kernel 2
   (v2) at 2/1, 3/1, 4/1, 5/1, center-aligned and reflect, widths that
   are and are not multiples of 16, supports 2, 3 and 4, dering on and
   off; the v1 kernels, every design and instantiation, each also with
   the generic design forced (the window design's compile-time pairs,
   its run-time form at center alignment, 5/4, supports 2 and 4 and a
   pair that is not built; the streamed design at 4, 6 and 8 live rows
   with reflect and zero edges, a support larger than the image, ragged
   stripes and chunks and a width that is not a multiple of 16, its two
   kernels also each against its own plain version; the generic design at
   2/3 and 37/25 by 61/41), six planes, and every ablation kernel (the
   dense design of the fused kernel), fp32 and bf16;
4. the main path: ``lanczos_torch.upscale(img, scale=(2, 1),
   profile="precise", a=3)`` on a seeded 2160×3840×3 uint8 frame in fp32
   and bf16, with the kernel's launch counts, held against a float64
   numpy separable gather and against the plain version;
5. times of the kernel and the plain version at 4K→8K (CUDA events),
   with the GB/s of the frame's compulsory traffic and the kernel's bound;
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
   version and a float64 gather, then again with the generic design
   forced (``design="generic"``: the kernel v1 had first), and the
   streamed design's two kernels each against its own plain version;
9. times of the v1 kernels, of the forced generic design beside them
   (their ``earlier_ms``) and of the plain versions on those three;
10. the ablation harness of the dense fused kernel
   (``lanczos_torch.tools.ablate_fused``) over every variant at 4K→8K, 12
   planes: each byte-equal to its dense plain version, held to the
   production kernel within the fused kernel's limits where it keeps its
   semantics, and timed beside it (``full`` / ``f32full`` are the
   production kernel's earlier, dense design: its ``earlier_ms``);
11. the bit-exact profiles on the card: ``hls`` and ``c_oracle`` at small
   seeds drawn as ``hwcert.py`` draws its exact seeds (plus ``hls`` at
   P = 6 and 10), each byte-equal to its ``lanczos_torch.ref`` oracle (run
   on host threads meanwhile); at 4K→8K, ``c_oracle`` a=3 byte-equal
   to ``c_oracle_upscale`` and ``hls`` a=2 byte-equal to the same module's
   run on the host CPU;
12. the float paths at full width, each against a float64 gather:
   ``backend="xla"`` uint8 fp32 and bf16 at 4K→8K; float32 and uint16
   input at 4K→8K through ``auto`` (the strided path); float32 1080×1920 →
   1126×2001 through ``auto`` (the block path), also with TF32 enabled,
   which must not change a byte;
13. times of every new path at full width through ``Upscaler``, beside the
   fused kernel on the same 4K→8K frame;
14. chunk plans at small shapes: the fused kernel on the hand-built chunk
   plans of ``StreamingUpscaler`` (seven config families, ragged tail
   chunks, a chunk of one tile, widths that break 16-byte traffic; fp32
   and bf16) against its plain version on the same plan; each streamed
   frame against the whole-frame kernel, with ``n_chunks`` launches; the
   gather and shift chunk paths byte-equal to the whole-frame gather on
   the card; pipelined (``depth=3``, prefetch thread) and resumed runs
   byte-equal to serial and full ones under a source that sleeps at
   random, and arrays yielded earlier unchanged by later chunks;
15. streaming at full width: the 4K frame through
   ``StreamingUpscaler(cfg, chunk_rows=1024, chunk_backend="mxu")`` in
   fp32, bf16 and with dering, against the float64 gathers and the
   whole-frame kernel; then a 17280×3840×3 frame streamed from host memory
   to 34560×7680×3, each chunk against the whole-frame kernel's rows, and
   the peak device memory of both;
16. video at full width: 16 4K frames through ``VideoUpscaler(cfg, batch=4,
   depth=3)`` by ``frames()`` (from a producer that reuses one buffer) and
   by ``__call__``, byte-equal to ``Upscaler`` a frame; a 4:2:0 ``.y4m``
   of 8 frames through ``upscale_y4m``, every plane byte-equal to
   ``Upscaler.planar``;
17. times: the pinned copy rates of this run, a streamed 4K→8K frame
   serial and pipelined, pageable and pinned, and where its time goes; the
   tall frame; video frames/s at batch 1, 4 and 8; ``upscale_y4m`` beside
   its reader, its writer and its kernels alone;
18. the sharded fused path: 2 4K frames through ``ShardedUpscaler`` on
   ``Mesh.local([cuda:0] * 8, (2, 4))`` in fp32, bf16, with dering and
   with the quantized intermediate, channel groups on and off, each with
   its launch count (R a frame, 2R with channel groups) and byte-equal to
   ``Upscaler(cfg)`` on the card;
19. the other sharded paths on (1, 4) at 4K→8K: gather (drop edges),
   shift, ``hls`` a=2, ``c_oracle`` a=3 and uint16, each byte-equal to the
   same path on one device;
20. ``ShardedStreamingUpscaler`` (R = 4, ``chunk_rows=1024``) on the
   17280×3840 frame, byte-equal to ``StreamingUpscaler``;
21. ``VideoUpscaler(mesh=(2, 2))`` on 16 4K frames, byte-equal to
   ``Upscaler`` a frame;
22. a one-rank NCCL process group: ``Mesh.distributed`` running the fused
   sharded path, equal to the local mesh; ``measure_ici_bw`` must raise;
23. times on one card for R = 1, 2, 4, 8: each shard's kernel (direct
   library calls), the halo copies, the sharded frame (events and wall),
   and ``ici_halo_model`` for 4 NVLink cards fed this run's frame time
   (a model, printed as one).

The run starts no worker process (the host references run on threads).
It makes itself the subreaper of whatever it starts, and at its end, and
on any failure, stops each process of the run still alive and names it.

Limits: fp32 ≤ 1 LSB on ≤ 1% of pixels (the quantized intermediate ≤ 2
LSB: one flipped intermediate value spreads over the taps); bf16 ≤ 3 LSB
on ≤ 50% of pixels; kernel 2, the v1 kernel and the ablation kernels and
their plain versions identical bytes; a streamed frame ≤ 1 LSB from the
whole-frame kernel in fp32 (the reference's contract for the fused chunk
path: edge rows come from a padded window, not from folded weights), in
bf16 within the bf16 limits of it; the bit-exact profiles and every
sharded path identical bytes; float output |Δ| ≤ 1e-3 (values 0–255).  The last lines are one
JSON object of the kernels and one of the device.  A v1 kernel's
``earlier_ms`` is the forced generic design's time on the same frame in
the same run (for the streamed design's two kernels, of the whole
resample they replace together).  Each kernel's
``bound_ms`` is the least time the card could take for its call: the
larger of its compulsory bytes (input read once, output written once)
over 3.35 TB/s and its needed multiply-adds (2·support·max(1, D/N) a
value and pass) over the 67 TFLOP/s SIMT fp32 peak; ``library_ms`` is
null for all: no single PyTorch call computes a Lanczos resample
(``F.interpolate`` has no Lanczos mode).
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50), "quant": (2, 0.01), "exact": (0, 0.0),
          "float": (1e-3, 1.0), "1 LSB": (1, 1.0)}
TALL = (17280, 3840)  # eight 4K frames' rows: the frame that makes streaming real
FRAME = (2160, 3840)  # the main path's input, 4K; output 2x each way
# a rational scale (563/540 by 667/640) only the block path takes
BLOCK_CASE = ((1080, 1920), (1126, 2001))
# H100 SXM, NVIDIA's data sheet at 700 W: SIMT fp32 and device memory
FP32_PEAK_TFLOPS = 67.0
HBM_TBPS = 3.35
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


def bound(cfg, nc: int) -> dict:
    """The least time the card could take for ``cfg`` on ``nc`` uint8
    planes, height first: ``bytes`` (input once, output once), ``flops``
    (two per needed multiply-add: 2·support·max(1, D/N) taps a value, the
    vertical pass over OH × W values and the horizontal over OH × OW),
    ``bound_ms`` the larger of their times and ``bound_by`` which."""
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape

    def taps(scale):
        n, d = scale
        return 2 * cfg.a * max(1.0, d / n)

    nbytes = nc * (ih * iw + oh * ow)
    flops = 2.0 * nc * (oh * iw * taps(cfg.scale_h) + oh * ow * taps(cfg.scale_w))
    t_bytes = nbytes / (HBM_TBPS * 1e12) * 1e3
    t_flops = flops / (FP32_PEAK_TFLOPS * 1e12) * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def entry(name: str, source: str, replaces: str, launches: int, err, ms: float,
          plain_ms: float, bnd: dict) -> dict:
    """One kernel's record in the ``kernels`` line."""
    return {
        "name": name, "route": "cuda", "source": "lanczos_torch/csrc/" + source,
        "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
        "library_ms": None,
    }


def dense_flops(plan, nc: int) -> float:
    """Flops of the dense kernel's products over one call (padding included):
    the ablation harness's kernels only."""
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
    # host threads, not worker processes: the run starts no process it could leave behind
    with ThreadPoolExecutor(3) as threads:
        big_c = threads.submit(c_oracle_upscale, img, *big_out, 3)
        big_h = threads.submit(
            lambda: Upscaler(cfg_h, device="cpu")(torch.from_numpy(img)).numpy())
        refs = [
            threads.submit(exact_oracle, prof, im,
                           (sh[0] * sc[0] // sc[1], sh[1] * sc[0] // sc[1]), a, bp)
            for _, prof, sh, sc, a, bp, im in seeds
        ]
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
    print(f"  host oracles (3 threads): "
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


def wall_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean host milliseconds per call of ``fn``, which must end with the
    device idle (the streaming and video entry points wait for their last
    readback); the card is synchronized before and after."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def sleepy(img: np.ndarray, seed: int):
    """A ``get_rows`` over ``img`` that sleeps up to 4 ms at random, so the
    prefetch thread and the copy streams run out of step."""
    naps = np.random.default_rng(seed).random(97) * 0.004

    def get_rows(lo, hi):
        time.sleep(naps[lo % 97])
        return img[lo:hi]

    return get_rows


def chunks_equal(name: str, got: list, want: list) -> None:
    ok = [y for y, _ in got] == [y for y, _ in want] and all(
        a.dtype == b.dtype and np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    print(f"  {name}: {len(got)} chunks {'identical' if ok else 'DIFFER'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: chunks differ")


def streaming_and_video(img: np.ndarray, x, smi: str, refs64: dict, kernels: list) -> None:
    """Phases 14–17: streaming and video, on ``img`` (``x`` on the card);
    the fused kernels' records in ``kernels`` gain the launches of a
    streamed frame and of the video runs."""
    import torch

    import lanczos_torch
    from lanczos_torch.io import y4m
    from lanczos_torch.ops import resample_cuda as rc

    dev = x.device
    Streaming, Upscaler = lanczos_torch.StreamingUpscaler, lanczos_torch.Upscaler

    def profile(shape, **kw):
        return lanczos_torch.ResampleConfig.from_profile("precise", shape, a=3, **kw)

    def noise(rng, *shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    # ---- 14. chunk plans at small shapes
    print("== 14. chunk plans: the fused kernel on StreamingUpscaler's hand-built plans, "
          "small shapes", flush=True)
    rng = np.random.default_rng(14)
    plans = [  # name, in, out, overrides, chunk_rows
        ("2x", (96, 64), (192, 128), {}, 32),
        ("3/2", (96, 64), (144, 96), {}, 24),
        ("1/2", (96, 64), (48, 32), {}, 16),
        ("reflect", (96, 64), (192, 128), {"edge_mode": "reflect"}, 32),
        ("dering", (96, 64), (192, 128), {"dering": True}, 32),
        ("quantize", (96, 64), (192, 128), {"intermediate_quantize": True}, 32),
        ("center", (96, 64), (192, 128), {"align": "center"}, 32),
        ("2/1 ragged tail of 8 rows, a chunk of one tile 100x300", (100, 300), (200, 600), {},
         64),
        ("2/1 odd W, OW=154, tail of 36 rows 90x77", (90, 77), (180, 154), {}, 48),
        ("3/2 OW=180 dering+quantize 80x120", (80, 120), (120, 180),
         {"dering": True, "intermediate_quantize": True}, 24),
        ("3/1 reflect, chunks of 64+32 rows 64x96", (64, 96), (192, 288),
         {"edge_mode": "reflect"}, 96),
        ("2/3 center-aligned downscale 120x96", (120, 96), (80, 64),
         {"align": "center"}, 16),
    ]
    for precision in ("fp32", "bf16"):
        for name, ins, outs, kw, chunk in plans:
            cfg = profile(ins, out_shape=outs, precision=precision, **kw)
            sm = Streaming(cfg, chunk_rows=chunk, chunk_backend="mxu")
            if sm.chunk_path != "fused" or sm.device.type != "cuda":
                raise AssertionError(f"{name}: chunk path {sm.chunk_path} on {sm.device}")
            ops = sm._mxu
            xw = torch.from_numpy(noise(rng, 3, sm.win, ins[1])).to(dev)
            got = rc.fused_call(ops, xw)
            want = rc.fused_resample_reference(xw, ops.plan, precision, ops.cfg.out_shape,
                                               cfg.dering, cfg.intermediate_quantize)
            torch.cuda.synchronize()
            compare(f"{ops.kernel} chunk plan {name} (window {sm.win}, tile "
                    f"{ops.plan.tile_out}x{ops.plan.cb}) vs plain version", got, want,
                    limits(cfg, "mxu"))
            frame = noise(rng, *ins, 3)
            torch.cuda.synchronize()
            reset_counts()
            out = sm(frame)
            n = read_counts()
            if n != {ops.kernel: sm.n_chunks}:
                raise AssertionError(f"{name}: launches {n}, expected {sm.n_chunks} of "
                                     f"{ops.kernel}")
            whole = Upscaler(cfg)(torch.from_numpy(frame).to(dev))
            compare(f"{precision} streamed {name} ({sm.n_chunks} chunks) vs whole-frame kernel",
                    out, whole, "1 LSB" if precision == "fp32" else "bf16")
    for scale in ((2, 1), (3, 2), (7, 2)):
        n_, d_ = scale
        ins = (48 * d_, 40 * d_)
        cfg = profile(ins, scale=scale)
        frame = noise(rng, *ins, 3)
        whole = Upscaler(cfg, backend="xla")(torch.from_numpy(frame).to(dev))
        for backend in ("gather", "shift"):
            sm = Streaming(cfg, chunk_rows=40, chunk_backend=backend)
            if sm.chunk_path != backend:
                raise AssertionError(f"{backend} at {scale}: took {sm.chunk_path}")
            compare(f"{backend} chunk path {n_}/{d_} {ins[0]}x{ins[1]} ({sm.n_chunks} chunks) "
                    "vs whole-frame gather on the card", sm(frame), whole, "exact")
    cfg = profile((600, 256), scale=(2, 1))
    frame = noise(rng, 600, 256, 3)
    for backend in ("mxu", "shift", "gather"):
        sm = Streaming(cfg, chunk_rows=64, chunk_backend=backend)
        serial = list(sm.chunks(lambda lo, hi: frame[lo:hi], depth=1, prefetch=False))
        held = [(y0, rows, rows.copy())
                for y0, rows in sm.chunks(sleepy(frame, 1), depth=3, prefetch=True)]
        chunks_equal(f"{sm.chunk_path} pipelined (depth 3, prefetch, sleeping source) vs serial",
                     [(y0, then) for y0, _, then in held], serial)
        chunks_equal(f"{sm.chunk_path} chunks yielded earlier, read again after the run",
                     [(y0, rows) for y0, rows, _ in held], serial)
        resumed = list(sm.chunks(sleepy(frame, 2), start_chunk=7, depth=2))
        chunks_equal(f"{sm.chunk_path} resumed at chunk 7 vs the tail of the full run",
                     resumed, serial[7:])

        def dies(lo, hi):
            if lo > 300:
                raise OSError("the source died")
            return frame[lo:hi]

        try:
            list(sm.chunks(dies, depth=3))
        except OSError as e:
            print(f"  {sm.chunk_path}: a raising get_rows re-raised at the consumer: {e}",
                  flush=True)
        else:
            raise AssertionError("a raising get_rows was swallowed")
        gen = sm.chunks(sleepy(frame, 3), depth=3)
        next(gen)
        gen.close()  # abandoned with chunks in flight
        chunks_equal(f"{sm.chunk_path} a run after a failed and an abandoned one",
                     list(sm.chunks(lambda lo, hi: frame[lo:hi])), serial)

    # ---- 15. streaming at full width
    print("== 15. streaming at full width: 2160x3840x3 -> 4320x7680x3 in chunks of 1024 "
          "rows", flush=True)
    streamed = {}  # kernel name -> launches of one streamed frame
    for name, kw, ref, lim in (("fp32", {}, "linear", "fp32"),
                               ("bf16", {"precision": "bf16"}, "linear", "bf16"),
                               ("fp32 dering", {"dering": True}, "dering", "fp32")):
        cfg = profile(FRAME, scale=(2, 1), **kw)
        sm = Streaming(cfg, chunk_rows=1024, chunk_backend="mxu")
        if sm.chunk_path != "fused":
            raise AssertionError(f"{name}: chunk path {sm.chunk_path}")
        torch.cuda.synchronize()
        reset_counts()
        out = sm(img)
        n = read_counts()
        print(f"  {name}: window {sm.win} rows, {sm.n_chunks} chunks, plan tile "
              f"{sm._mxu.plan.tile_out}x{sm._mxu.plan.cb}; launches {n}", flush=True)
        if n != {sm._mxu.kernel: sm.n_chunks}:
            raise AssertionError(f"{name}: expected {sm.n_chunks} launches of "
                                 f"{sm._mxu.kernel}, got {n}")
        streamed[sm._mxu.kernel] = sm.n_chunks
        if out.shape != (2 * FRAME[0], 2 * FRAME[1], 3) or out.dtype != np.uint8:
            raise AssertionError(f"{name}: got {out.shape} {out.dtype}")
        compare(f"{name} streamed vs float64 gather", out, refs64[ref], lim)
        whole = lanczos_torch.upscale(x, scale=(2, 1), profile="precise", a=3, **kw)
        # bf16: the sum-keeping rounding puts each output's residual on its largest
        # tap, and at the half-pixel phase two taps tie: the chunk plan's operator and
        # the frame's differ in the last bits of a float64 and may pick either
        compare(f"{name} streamed vs whole-frame kernel", out, whole,
                "bf16" if lim == "bf16" else "1 LSB")
        del out, whole
    refs64.clear()
    torch.cuda.empty_cache()

    tall = np.random.default_rng(15).integers(0, 256, TALL + (3,), dtype=np.uint8)
    cfg_t = profile(TALL, scale=(2, 1))
    sm_t = Streaming(cfg_t, chunk_rows=1024, chunk_backend="mxu")
    depth = 3
    parts = list(sm_t.chunks(lambda lo, hi: tall[lo:hi], depth=depth))  # tables, staging caches
    del parts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    parts = list(sm_t.chunks(lambda lo, hi: tall[lo:hi], depth=depth))
    torch.cuda.synchronize()
    peak_streamed = torch.cuda.max_memory_allocated() - base
    n = read_counts()
    if n != {"fused_resample_fp32": sm_t.n_chunks}:
        raise AssertionError(f"tall frame: launches {n}, expected {sm_t.n_chunks}")
    torch.cuda.reset_peak_memory_stats()
    whole_t = Upscaler(cfg_t)(torch.from_numpy(tall).to(dev))
    torch.cuda.synchronize()
    peak_whole = torch.cuda.max_memory_allocated() - base
    whole_np = whole_t.cpu().numpy()
    del whole_t
    torch.cuda.empty_cache()
    worst, differing = 0, 0
    for y0, rows in parts:
        d = np.abs(rows.astype(np.int16) - whole_np[y0 : y0 + rows.shape[0]])
        worst, differing = max(worst, int(d.max())), differing + int((d > 0).sum())
    print(f"  tall frame {TALL[0]}x{TALL[1]}x3 ({tall.nbytes / 1e6:.0f} MB) -> "
          f"{whole_np.shape[0]}x{whole_np.shape[1]}x3 in {len(parts)} chunks: max|d|={worst} "
          f"differing={differing / whole_np.size:.6f} vs the whole-frame kernel's rows "
          f"({'ok' if worst <= 1 else 'FAIL'})", flush=True)
    if worst > 1 or sum(r.shape[0] for _, r in parts) != whole_np.shape[0]:
        raise AssertionError("tall frame: a streamed chunk is past 1 LSB of the whole frame")
    c = 3
    a_chunk = c * (sm_t.win * TALL[1] + sm_t.chunk * 2 * TALL[1])  # a window and a chunk of rows
    predicted = (depth + 1) * a_chunk  # depth chunks in flight and one chunk's temporaries
    print(f"  peak device memory: streamed {peak_streamed / 1e6:.1f} MB (predicted "
          f"{predicted / 1e6:.1f} MB from depth {depth}, window {sm_t.win}, chunk "
          f"{sm_t.chunk}), whole-frame call {peak_whole / 1e6:.1f} MB [{smi}]", flush=True)
    if not (peak_streamed < peak_whole / 3 and predicted / 2 <= peak_streamed <= 2 * predicted):
        raise AssertionError("the streamed run's device memory is not bounded as predicted")
    del parts, whole_np

    # ---- 16. video at full width
    print("== 16. video at full width: 16 frames 2160x3840x3 -> 4320x7680x3", flush=True)
    cfg = profile(FRAME, scale=(2, 1))
    frames16 = np.random.default_rng(16).integers(0, 256, (16,) + FRAME + (3,), dtype=np.uint8)
    single = Upscaler(cfg)
    vu = lanczos_torch.VideoUpscaler(cfg, batch=4, depth=3)
    buf = np.empty_like(frames16[0])

    def producer():
        for f in frames16:
            buf[...] = f  # one buffer, rewritten between pulls
            yield buf

    torch.cuda.synchronize()
    reset_counts()
    outs = list(vu.frames(producer()))
    n = read_counts()
    print(f"  frames(): {len(outs)} frames, launches {n}", flush=True)
    if n != {"fused_resample_fp32": 4} or len(outs) != 16:
        raise AssertionError(f"video: launches {n}, {len(outs)} frames")
    reset_counts()
    called = vu(frames16)
    video_launches = read_counts()
    if video_launches != {"fused_resample_fp32": 4}:
        raise AssertionError(f"video __call__: launches {video_launches}")
    bad = []
    for k in range(16):
        want = single(torch.from_numpy(frames16[k]).to(dev)).cpu().numpy()
        if not (np.array_equal(outs[k], want) and np.array_equal(called[k], want)):
            bad.append(k)
    print(f"  frames() and __call__ vs Upscaler(cfg) a frame: "
          f"{'identical' if not bad else f'frames {bad} DIFFER'}", flush=True)
    if bad:
        raise AssertionError(f"video frames {bad} differ from Upscaler")
    del outs, called

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(17)
        ch, cw = FRAME[0] // 2, FRAME[1] // 2
        clip = [(noise(rng, *FRAME), noise(rng, ch, cw), noise(rng, ch, cw)) for _ in range(8)]
        src, dst = f"{tmp}/in.y4m", f"{tmp}/out.y4m"
        in_hdr = y4m.Y4MHeader(FRAME[1], FRAME[0], fps=(24, 1), colorspace="420jpeg")
        with y4m.Y4MWriter(src, in_hdr) as writer:
            for f in clip:
                writer.write(f)
        torch.cuda.synchronize()
        reset_counts()
        hdr = lanczos_torch.upscale_y4m(src, dst, scale=(2, 1))
        y4m_launches = read_counts()
        want_hdr = y4m.Y4MHeader(
            2 * FRAME[1], 2 * FRAME[0], fps=in_hdr.fps, interlace=in_hdr.interlace,
            aspect=in_hdr.aspect, colorspace=in_hdr.colorspace, extensions=in_hdr.extensions)
        hdr2, got = y4m.read_y4m(dst)
        print(f"  upscale_y4m: {len(got)} frames, header {hdr.tag_line()!r}, launches "
              f"{y4m_launches}", flush=True)
        if not (hdr == want_hdr == hdr2) or len(got) != 8:
            raise AssertionError(f"upscale_y4m: header {hdr} or {len(got)} frames")
        if y4m_launches != {"fused_resample_fp32": 2}:  # one luma, one Cb+Cr dispatch a batch
            raise AssertionError(f"upscale_y4m: launches {y4m_launches}")
        ups = {p.shape: Upscaler(profile(p.shape, scale=(2, 1))) for p in clip[0]}
        bad = [
            (k, i) for k, (f_in, f_out) in enumerate(zip(clip, got))
            for i, (p_in, p_out) in enumerate(zip(f_in, f_out))
            if not np.array_equal(
                p_out, ups[p_in.shape].planar(torch.from_numpy(p_in[None]).to(dev))[0]
                .cpu().numpy())
        ]
        print(f"  every plane vs Upscaler.planar: "
              f"{'identical' if not bad else f'(frame, plane) {bad} DIFFER'}", flush=True)
        if bad:
            raise AssertionError(f"upscale_y4m planes {bad} differ from Upscaler.planar")
        for k in kernels:
            if k["name"] in streamed:
                k["streamed_launches"] = streamed[k["name"]]
            if k["name"] == "fused_resample_fp32":
                k["video_launches"] = video_launches[k["name"]]
                k["y4m_launches"] = y4m_launches[k["name"]]

        # ---- 17. times
        print(f"== 17. times of streaming and video [{smi}]", flush=True)
        times_of_streaming_and_video(img, x, tall, sm_t, frames16, clip, got, src, tmp)


def times_of_streaming_and_video(img, x, tall, sm_t, frames16, clip, clip_out, src, tmp) -> None:
    """Phase 17.  ``event`` times are CUDA events on the stream named;
    ``wall`` times are the host's clock around calls that end with the
    device idle."""
    import torch

    import lanczos_torch
    from lanczos_torch.io import y4m
    from lanczos_torch.models._pipeline import host_copy, host_empty
    from lanczos_torch.models.streaming import _window
    from lanczos_torch.ops import resample_cuda as rc
    from lanczos_torch.utils.timing import cuda_time_ms

    dev = x.device
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", FRAME, scale=(2, 1), a=3)
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=1024, chunk_backend="mxu")
    c = 3
    window_bytes = sm.win * FRAME[1] * c
    chunk_bytes = sm.chunk * 2 * FRAME[1] * c
    up_bytes, down_bytes = sm.n_chunks * window_bytes, 4 * img.nbytes

    # the link, on pinned buffers of the sizes a streamed frame moves
    rates = {}
    for name, nbytes in (("window", window_bytes), ("chunk", chunk_bytes),
                         ("frame in", img.nbytes), ("frame out", 4 * img.nbytes)):
        host = host_empty((nbytes,), torch.uint8, True)
        card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        up = cuda_time_ms(lambda: card.copy_(host, non_blocking=True))
        down = cuda_time_ms(lambda: host.copy_(card, non_blocking=True))
        rates[name] = (nbytes / up / 1e6, nbytes / down / 1e6)
        print(f"  pinned copy of a {name} ({nbytes / 1e6:.1f} MB, event, mean of 20): up "
              f"{up:.4f} ms = {rates[name][0]:.1f} GB/s, down {down:.4f} ms = "
              f"{rates[name][1]:.1f} GB/s", flush=True)
        del host, card
    t_up = up_bytes / rates["window"][0] / 1e6
    t_down = down_bytes / rates["chunk"][1] / 1e6
    print(f"  a streamed 4K->8K frame moves {up_bytes / 1e6:.1f} MB up ({sm.n_chunks} windows "
          f"of {sm.win} rows) and {down_bytes / 1e6:.1f} MB down: {t_up:.3f} ms and "
          f"{t_down:.3f} ms at those rates; the slower direction {max(t_up, t_down):.3f} ms",
          flush=True)

    # the device's share: the chunk function on resident windows
    window = x[: sm.win].contiguous()
    dev_ms = sm.n_chunks * cuda_time_ms(lambda: sm._chunk_fn(window).contiguous())
    ops = rc.FusedOps(cfg, "cuda")
    planar = x.permute(2, 0, 1).contiguous()
    whole_ms = cuda_time_ms(lambda: rc.fused_call(ops, planar))
    print(f"  device work of a streamed frame ({sm.n_chunks} x permute, kernel, permute; "
          f"event): {dev_ms:.4f} ms; the whole-frame kernel {whole_ms:.4f} ms", flush=True)
    # the host's share: fetching every window into its staging buffer
    stage = host_empty((sm.win,) + img.shape[1:], torch.uint8, True).numpy()
    for name, source, target in (("window", img[: sm.win], stage),
                           ("frame", img, host_empty(img.shape, torch.uint8, True).numpy())):
        plain = wall_ms(lambda: target.__setitem__(Ellipsis, source), iters=10)
        threaded = wall_ms(lambda: host_copy(target, source), iters=10)
        print(f"  host copy of a {name} into pinned memory ({source.nbytes / 1e6:.1f} MB; wall): "
              f"numpy assignment {plain:.3f} ms = {source.nbytes / plain / 1e6:.1f} GB/s, "
              f"host_copy on {torch.get_num_threads()} threads {threaded:.3f} ms = "
              f"{source.nbytes / threaded / 1e6:.1f} GB/s", flush=True)

    def fetch_all():
        for k in range(sm.n_chunks):
            _, _, (rows, top, bot, mode), _ = sm._host_chunk_args(k, lambda lo, hi: img[lo:hi])
            _window(stage, rows, top, bot, mode)

    fetch_ms = wall_ms(fetch_all, iters=10)
    print(f"  host work of a streamed frame (every window fetched, padded and copied into a "
          f"pinned buffer; wall): {fetch_ms:.3f} ms = {up_bytes / fetch_ms / 1e6:.1f} GB/s",
          flush=True)

    def run(model, source, depth, prefetch):
        for _ in model.chunks(source, depth=depth, prefetch=prefetch):
            pass

    results = {}
    for pinned in (False, True, True, False):
        sm.pinned = pinned
        for mode, depth, prefetch in (("serial", 1, False), ("pipelined", 3, True)):
            ms = wall_ms(lambda: run(sm, lambda lo, hi: img[lo:hi], depth, prefetch), iters=8)
            results.setdefault(("pinned" if pinned else "pageable", mode), []).append(ms)
    sm.pinned = True
    for (memory, mode), (a, b) in results.items():
        print(f"  streamed 4K->8K frame, {memory}, {mode} (chunks(); wall, mean of 8, two "
              f"turns): {a:.3f} / {b:.3f} ms = {(a + b) / 2 / max(t_up, t_down):.2f}x the "
              f"slower copy direction; device work {dev_ms / ((a + b) / 2):.3f} of it",
              flush=True)
    call_ms = wall_ms(lambda: sm(img), iters=8)
    print(f"  StreamingUpscaler.__call__ (pinned, depth 3, prefetch, read back into one "
          f"pinned frame; wall): {call_ms:.3f} ms", flush=True)

    tall_ms = wall_ms(lambda: run(sm_t, lambda lo, hi: tall[lo:hi], 3, True), iters=3, warmup=1)
    mpix = 4 * TALL[0] * TALL[1] / 1e6
    print(f"  tall frame {TALL[0]}x{TALL[1]} -> {2 * TALL[0]}x{2 * TALL[1]}, {sm_t.n_chunks} "
          f"chunks (chunks(), depth 3, prefetch; wall): {tall_ms:.2f} ms = "
          f"{mpix / tall_ms * 1e3:.0f} Mpix/s of output, "
          f"{tall_ms / (4 * tall.nbytes / rates['chunk'][1] / 1e6):.2f}x its down-copy time",
          flush=True)

    for batch in (1, 4, 8):
        vu = lanczos_torch.VideoUpscaler(cfg, batch=batch, depth=3)

        def play():
            for _ in vu.frames(iter(frames16)):
                pass

        ms = wall_ms(play, iters=3, warmup=1)
        print(f"  VideoUpscaler.frames(), batch {batch}, depth 3, 16 frames 4K->8K (wall): "
              f"{ms / 16:.3f} ms/frame = {16e3 / ms:.1f} frames/s; the down-copy alone "
              f"{4 * img.nbytes / rates['frame out'][1] / 1e6:.3f} ms/frame", flush=True)

    n = len(clip)
    total = wall_ms(lambda: lanczos_torch.upscale_y4m(src, f"{tmp}/timed.y4m", scale=(2, 1)),
                    iters=2, warmup=1)

    def read_all():
        with y4m.Y4MReader(src) as reader:
            for _ in reader:
                pass

    read_ms = wall_ms(read_all, iters=2, warmup=1)
    write_ms = wall_ms(lambda: y4m.write_y4m(f"{tmp}/written.y4m", clip_out, fps=(24, 1)),
                       iters=2, warmup=1)
    luma = torch.from_numpy(np.stack([f[0] for f in clip])[:, None]).to(dev)
    chroma = torch.from_numpy(np.stack([np.stack(f[1:]) for f in clip])).to(dev)
    ups = [lanczos_torch.Upscaler(lanczos_torch.ResampleConfig.from_profile(
        "precise", tuple(t.shape[-2:]), scale=(2, 1), a=3)) for t in (luma, chroma)]
    kernels_ms = cuda_time_ms(lambda: [u.planar(t) for u, t in zip(ups, (luma, chroma))])
    moved = sum(p.nbytes for p in clip[0]) / rates["frame in"][0] / 1e6 + sum(
        p.nbytes for p in clip_out[0]) / rates["frame out"][1] / 1e6
    print(f"  upscale_y4m, {n} frames 4:2:0 2160x3840 -> 4320x7680, batch 8, depth 3 (wall): "
          f"{total / n:.2f} ms/frame = {n * 1e3 / total:.1f} frames/s; alone: reader "
          f"{read_ms / n:.2f} ms/frame ({read_ms / total:.2f} of it), writer "
          f"{write_ms / n:.2f} ({write_ms / total:.2f}), kernels {kernels_ms / n:.3f} "
          f"({kernels_ms / total:.4f}; event), copies at the pinned rates {moved:.3f} "
          f"({moved * n / total:.3f})", flush=True)


def sharding(img: np.ndarray, x, smi: str, kernels: list) -> None:
    """Phases 18–23: row and batch sharding on one card, ``img`` (``x`` on
    the card) its 4K frame; the fused kernels' records gain the launches of
    the sharded main path."""
    import socket

    import torch
    import torch.distributed as dist

    import lanczos_torch
    from lanczos_torch.parallel import multihost
    from lanczos_torch.parallel.mesh import Mesh, halo_exchange_rows
    from lanczos_torch.ops import _build, resample_cuda as rc
    from lanczos_torch.tools import probe_kernels as pk
    from lanczos_torch.utils.timing import cuda_time_ms

    dev = x.device
    Upscaler, Sharded = lanczos_torch.Upscaler, lanczos_torch.ShardedUpscaler

    def profile(shape, name="precise", **kw):
        return lanczos_torch.ResampleConfig.from_profile(name, shape, **kw)

    def mesh_of(shape):
        return Mesh.local([dev] * (shape[0] * shape[1]), shape)

    def identical(name: str, got, want) -> None:
        same = got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
        print(f"  {name}: {'identical' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{name}: not byte-equal to the single-device result")

    # ---- 18. the sharded fused path at full width
    print("== 18. sharded fused path: 2 frames 2160x3840x3 -> 4320x7680x3 on "
          "Mesh.local([cuda:0] * 8, (2, 4))", flush=True)
    frames2 = torch.stack([x, torch.from_numpy(np.random.default_rng(18).integers(
        0, 256, FRAME + (3,), dtype=np.uint8)).to(dev)])
    mesh24 = mesh_of((2, 4))
    sharded = {}
    for name, kw in (("fp32", {}), ("bf16", {"precision": "bf16"}), ("fp32 dering",
                     {"dering": True}), ("fp32 quantize", {"intermediate_quantize": True})):
        cfg = profile(FRAME, scale=(2, 1), a=3, **kw)
        want = Upscaler(cfg)(frames2)
        for overlap in (True, False):
            sh = Sharded(cfg, mesh24, overlap=overlap)
            if not sh.use_mxu:
                raise AssertionError(f"{name}: the sharded model did not take the fused path")
            kernel = sh._tables(dev).fused.kernel
            torch.cuda.synchronize()
            reset_counts()
            got = sh(frames2)
            torch.cuda.synchronize()
            n = read_counts()
            expect = (2 if overlap else 1) * 8
            plan = sh._plans[0]
            print(f"  {name}, overlap {overlap}: shard plan tile {plan.tile_out}x{plan.cb}, kv "
                  f"{plan.kv}, win_v {plan.win_v}, halo {sh.halo}; launches {n}", flush=True)
            if n != {kernel: expect}:
                raise AssertionError(f"{name}: expected {expect} launches of {kernel}, got {n}")
            if overlap:
                sharded[kernel] = expect
            identical(f"{name} sharded (overlap {overlap}) vs Upscaler(cfg) on the card", got, want)
            del got
        del want
    for k in kernels:
        if k["name"] in sharded:
            k["sharded_launches"] = sharded[k["name"]]
    torch.cuda.empty_cache()

    # ---- 19. the other sharded paths
    print("== 19. the other sharded paths at 4K->8K on Mesh.local([cuda:0] * 4, (1, 4))",
          flush=True)
    mesh14 = mesh_of((1, 4))
    x1 = x[None]
    img16 = torch.from_numpy(np.random.default_rng(19).integers(
        0, 65536, (1,) + FRAME + (3,), dtype=np.uint16)).to(dev)
    others = [  # name, config, sharded backend, input, single-device backends it must equal
        ("gather (drop edges)", profile(FRAME, scale=(2, 1), a=3, edge_mode="drop"), "gather",
         x1, ("xla",)),
        ("shift", profile(FRAME, scale=(2, 1), a=3), "gather", x1, ("xla", "shift_xla")),
        ("hls a=2", profile(FRAME, "hls", scale=(2, 1), a=2), "auto", x1, ("auto",)),
        ("c_oracle a=3", profile(FRAME, "c_oracle", scale=(2, 1), a=3), "auto", x1, ("auto",)),
        ("uint16", profile(FRAME, scale=(2, 1), a=3), "auto", img16, ("xla",)),
    ]
    for name, cfg, backend, xin, singles in others:
        sh = Sharded(cfg, mesh14, backend=backend)
        path = ("shift" if sh.use_shift else "gather") if not (sh.fixed or sh.c_exact) else (
            "hls" if sh.fixed else "c_exact")
        reset_counts()
        got = sh(xin)
        torch.cuda.synchronize()
        if read_counts():
            raise AssertionError(f"{name}: launched {read_counts()}")
        for single in singles:
            up = Upscaler(cfg, backend=single)
            identical(f"{name} sharded ({path}, halo {sh.halo}) vs Upscaler(backend="
                      f"{single!r}: {up.path})", got, up(xin))
        del got
        torch.cuda.empty_cache()

    # ---- 20. the sharded stream
    print(f"== 20. ShardedStreamingUpscaler (R = 4, chunk_rows=1024) on {TALL[0]}x{TALL[1]}x3",
          flush=True)
    tall = np.random.default_rng(15).integers(0, 256, TALL + (3,), dtype=np.uint8)
    cfg_t = profile(TALL, scale=(2, 1), a=3)
    base = lanczos_torch.StreamingUpscaler(cfg_t, chunk_rows=1024, device=dev)
    want = list(base.chunks(lambda lo, hi: tall[lo:hi]))
    ssm = lanczos_torch.ShardedStreamingUpscaler(cfg_t, mesh14, chunk_rows=1024)
    if ssm.chunk_path != "fused":
        raise AssertionError(f"sharded stream: chunk path {ssm.chunk_path}")
    torch.cuda.synchronize()
    reset_counts()
    got = list(ssm.chunks(lambda lo, hi: tall[lo:hi]))
    n = read_counts()
    print(f"  {ssm.n_chunks} chunks in {ssm.n_groups} super-chunks of 4; launches {n}",
          flush=True)
    if n != {"fused_resample_fp32": 4 * ssm.n_groups}:
        raise AssertionError(f"sharded stream: launches {n}")
    chunks_equal("sharded stream vs StreamingUpscaler", got, want)
    del got, want

    # ---- 21. video on a mesh
    print("== 21. VideoUpscaler(mesh=Mesh.local([cuda:0] * 4, (2, 2))): 16 frames 4K->8K",
          flush=True)
    cfg = profile(FRAME, scale=(2, 1), a=3)
    frames16 = np.random.default_rng(16).integers(0, 256, (16,) + FRAME + (3,), dtype=np.uint8)
    vu = lanczos_torch.VideoUpscaler(cfg, batch=3, mesh=mesh_of((2, 2)))
    reset_counts()
    called = vu(frames16)
    n = read_counts()
    print(f"  batch {vu.batch} (3 rounded up to the data axis); launches {n}", flush=True)
    if n != {"fused_resample_fp32": 16 // vu.batch * 4 * 2}:
        raise AssertionError(f"video on a mesh: launches {n}")
    single = Upscaler(cfg)
    bad = [k for k in range(16) if not np.array_equal(
        called[k], single(torch.from_numpy(frames16[k]).to(dev)).cpu().numpy())]
    print(f"  every frame vs Upscaler(cfg): {'identical' if not bad else f'{bad} DIFFER'}",
          flush=True)
    if bad:
        raise AssertionError(f"video on a mesh: frames {bad} differ")
    del called, frames16

    # ---- 22. a distributed mesh: one rank, NCCL
    print("== 22. Mesh.distributed on a one-rank NCCL group", flush=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0, backend="nccl")
    try:
        dmesh = Mesh.distributed((2, 4), [dev] * 8)
        print(f"  {dmesh}, backend {dist.get_backend()}", flush=True)
        cfg = profile(FRAME, scale=(2, 1), a=3)
        reset_counts()
        got = Sharded(cfg, dmesh)(frames2)
        torch.cuda.synchronize()
        print(f"  launches {read_counts()}", flush=True)
        identical("fused path on the distributed mesh vs the local mesh", got,
                  Sharded(cfg, mesh24)(frames2))
        try:
            multihost.measure_ici_bw(dmesh)
        except ValueError as e:
            print(f"  measure_ici_bw on one card raised, as it must: {e}", flush=True)
        else:
            raise AssertionError("measure_ici_bw measured a ring on one card")
        del got
    finally:
        dist.destroy_process_group()
    del frames2

    # ---- 23. times
    print(f"== 23. sharding times on one card, 4K->8K fp32, one frame [{smi}]", flush=True)
    cfg = profile(FRAME, scale=(2, 1), a=3)
    whole_ops = rc.FusedOps(cfg, dev)
    planar = x.permute(2, 0, 1).contiguous()
    launch = _build.library().lanczos_fused_resample

    def kernel_ms(call) -> float:
        """Device ms of the one launch ``call`` makes, repeated as direct
        library calls (the wrapper's host cost kept out)."""
        args, out = pk.launch_args("lanczos_fused_resample", call)
        ms = pk.time_ms(launch, args, iters=50)
        del out  # the launches wrote into it
        return ms

    whole_ms = kernel_ms(lambda: rc.fused_call(whole_ops, planar))
    print(f"  whole-frame kernel (50 direct calls; event): {whole_ms:.4f} ms", flush=True)
    frame_ms = {}
    for R in (1, 2, 4, 8):
        mesh = mesh_of((1, R))
        sh = Sharded(cfg, mesh, overlap=False)
        t = sh._tables(dev)
        ext = halo_exchange_rows(mesh, sh._blocks(x1), sh.halo)
        planars = {p: e[0].permute(2, 0, 1).contiguous() for p, e in ext.items()}
        shard_ms = [kernel_ms(lambda: rc.fused_call(t.fused, pl, wv=t.wv[p[1]]))
                    for p, pl in planars.items()]
        blocks = sh._blocks(x1)
        halo_ms = cuda_time_ms(lambda: halo_exchange_rows(mesh, blocks, sh.halo))
        serial_ev = cuda_time_ms(lambda: sh(x1))
        serial_wall = wall_ms(lambda: sh(x1), iters=20)
        over = Sharded(cfg, mesh)
        over_ev, over_wall = cuda_time_ms(lambda: over(x1)), wall_ms(lambda: over(x1), iters=20)
        frame_ms[R] = serial_ev
        halo_bytes = sh.halo_spec()["bytes"]
        print(f"  R={R}: shard kernels (direct calls; event) "
              f"{', '.join(f'{m:.4f}' for m in shard_ms)} ms, sum {sum(shard_ms):.4f} "
              f"({sum(shard_ms) / whole_ms:.2f}x the whole-frame kernel); halo exchange of the "
              f"frame (event) {halo_ms:.4f} ms, {halo_bytes} B a direction a shard; sharded "
              f"frame serial {serial_ev:.4f} ms event / {serial_wall:.4f} ms wall "
              f"({R} launches: {serial_wall / R:.4f} ms wall a launch), overlapped (2 channel "
              f"groups) {over_ev:.4f} / {over_wall:.4f} ({2 * R} launches)", flush=True)
    model = multihost.ici_halo_model(cfg, 4, whole_ms * 1e-3)
    print(f"  MODEL, not a measurement: ici_halo_model for 4 cards of one NVLink node "
          f"(NVLink 4 at the 450 GB/s a direction of NVIDIA's specification), fed this run's "
          f"whole-frame kernel time {whole_ms:.4f} ms: {json.dumps(model)}", flush=True)


PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def adopt_orphans() -> None:
    """Make this process the subreaper of every process the run starts
    (Linux): a grandchild whose parent exits is re-parented here, where
    ``stop_leftovers`` finds it, and not to init."""
    try:
        ctypes.CDLL(None).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def children() -> dict:
    """pid -> (state, command line) of this process's children, from /proc."""
    me, out = os.getpid(), {}
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return out
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError):
            continue
        if int(ppid) == me:
            out[int(pid)] = (state, cmd)
    return out


def stop_leftovers(out=sys.stdout) -> list:
    """Stop every process of this run that is still alive (SIGTERM, SIGKILL
    after 5 s) and reap those that have exited; returns, and prints to
    ``out``, the command lines of those that were still running."""
    running = {p: cmd for p, (state, cmd) in children().items() if state != "Z"}
    for pid, cmd in running.items():
        print(f"  stopping a process the run left running: pid {pid}: {cmd}", file=out,
              flush=True)
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + 5.0
    while any(s != "Z" for s, _ in children().values()) and time.monotonic() < deadline:
        time.sleep(0.05)
    for pid, (state, _) in children().items():
        try:
            if state != "Z":
                os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return list(running.values())


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
        ("1/2 downscale 128x512 (17-step windows)", (128, 512), (1, 2), 1, {}, None),
        ("2/1 odd W, OW=154 (byte loads and stores) 50x77", (50, 77), (2, 1), 1, {}, None),
        ("3/1 OW=288, blocks off 16-byte bounds 45x96", (45, 96), (3, 1), 1, {}, None),
        ("3/2 OW=180 (16-byte loads, byte stores) 40x120", (40, 120), (3, 2), 1, {}, None),
        ("2/1 one tile, one block 12x16", (12, 16), (2, 1), 1, {}, None),
        ("2/1 all paths 16-byte aligned 64x256", (64, 256), (2, 1), 1, {}, None),
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
        ("dering odd W, OW=154 50x77", (50, 77), (2, 1), 1, {"dering": True}),
        ("dering+quantize OW=180 40x120", (40, 120), (3, 2), 1,
         {"dering": True, "intermediate_quantize": True}),
        ("dering one tile, one block 12x16", (12, 16), (2, 1), 1, {"dering": True}),
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
        ("4/1 copied 16-byte chunks 40x64", (40, 64), (4, 1), {}),
        ("3/1 reflect, 4 row tiles 70x160", (70, 160), (3, 1), {"edge_mode": "reflect"}),
        ("2/1 4 column chunks 64x256", (64, 256), (2, 1), {}),
        ("5/1 odd widths 33x47", (33, 47), (5, 1), {}),
        ("2/1 support 2 30x48", (30, 48), (2, 1), {"a": 2}),
        ("3/1 support 4 (generic) 30x48", (30, 48), (3, 1), {"a": 4}),
    ]
    for dering in (True, False):
        for name, (h, w), scale, kw in v2_cases:
            kw = dict(kw)
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", (h, w), scale=scale, a=kw.pop("a", 3), dering=dering, **kw
            )
            ops = rc.FusedOps(cfg, "cuda", variant="v2")
            x = torch.from_numpy(rng.integers(0, 256, (3, h, w), dtype=np.uint8)).cuda()
            got = rc.upscale_planar(x, ops)
            want = plain_version(x, ops)
            torch.cuda.synchronize()
            compare(f"{ops.kernel} {name}{' dering' if dering else ''}", got, want,
                    "exact")
    from lanczos_torch.ops import resample_phase_cuda as rp

    v1_cases = [  # name, (h, w), out, overrides
        ("3/2 24x40", (24, 40), (36, 60), {}),
        ("2/3 align=center 36x60 (generic)", (36, 60), (24, 40), {"align": "center"}),
        ("37/25 by 61/41 25x41 (generic)", (25, 41), (37, 61), {}),
        ("3/2 by 1/1 drop 24x40", (24, 40), (36, 40),
         {"edge_mode": "drop", "normalize": False}),
        ("3/2, 16-byte chunks, 3x3 blocks 96x160", (96, 160), (144, 240), {}),
        ("4/3 81x144", (81, 144), (108, 192), {}),
        ("1/1 by 4/3 70x96", (70, 96), (70, 128), {}),
        ("4/3 by 1/1, W % 16 != 0 81x100", (81, 100), (108, 100), {}),
        ("1/1 by 3/2 reflect 50x64", (50, 64), (50, 96), {"edge_mode": "reflect"}),
        ("2/1 by 3/2 reflect 24x40", (24, 40), (48, 60), {"edge_mode": "reflect"}),
        ("3/2 by 2/1 40x70", (40, 70), (60, 140), {}),
        ("3/2 align=center 90x120 (run-time form)", (90, 120), (135, 180),
         {"align": "center"}),
        ("5/4 48x80 (run-time form)", (48, 80), (60, 100), {}),
        ("3/2 support 2 48x80 (run-time form)", (48, 80), (72, 120), {"a": 2}),
        ("3/2 support 4 drop 34x46 (run-time form)", (34, 46), (51, 69),
         {"a": 4, "edge_mode": "drop", "normalize": False}),
        ("3/2 by 4/3 60x90 (no such pair: run-time form)", (60, 90), (90, 120), {}),
        ("1/16 256x256 (support 48)", (256, 256), (16, 16), {}),
        ("1/16 384x384 (ragged chunks)", (384, 384), (24, 24), {}),
        ("1/16 reflect 32x48 (support > image)", (32, 48), (2, 3), {"edge_mode": "reflect"}),
        ("1/4, second stripe of 80 columns 512x208", (512, 208), (128, 52), {}),
        ("1/4 by 1/2, W % 16 != 0 128x50", (128, 50), (32, 25), {}),
        ("1/8 by 1/4 drop 128x64", (128, 64), (16, 16),
         {"edge_mode": "drop", "normalize": False}),
        ("1/4 align=center 128x64", (128, 64), (32, 16), {"align": "center"}),
        ("1/8 by 3/2 support 2 (4 live rows) 128x48", (128, 48), (16, 72), {"a": 2}),
        ("1/5 by 1/1 support 4 (8 live rows) 160x32", (160, 32), (32, 32), {"a": 4}),
        ("1/16 by 1/1 reflect, six stripes 640x700", (640, 700), (40, 700),
         {"edge_mode": "reflect"}),
    ]
    reached = set()
    for precision in ("fp32", "bf16"):
        for name, (h, w), out, kw in v1_cases:
            kw = dict(kw)
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", (h, w), out_shape=out, a=kw.pop("a", 3), precision=precision, **kw
            )
            x = torch.from_numpy(rng.integers(0, 256, (6, h, w), dtype=np.uint8)).cuda()
            auto = rc.FusedOps(cfg, "cuda", variant="v1")
            want = plain_version(x, auto)
            for ops in (auto, rc.FusedOps(cfg, "cuda", variant="v1", design="generic")):
                got = rc.upscale_planar(x, ops)
                torch.cuda.synchronize()
                compare(f"{precision} v1 {ops.phase.design} {name}", got, want, "exact")
            pops = auto.phase
            templ = pops.layout.get("templ")
            reached.add((pops.kernels, templ, (
                pops.plan.v.n, pops.plan.v.d, pops.plan.h.n, pops.plan.h.d) if templ else None))
            if pops.design == "stream":  # each of its kernels against its own plain version
                mid = rp.stream_v_call(pops, x, rpc=5)
                want_mid = rp.stream_v_reference(x, pops.plan, precision, out[0])
                torch.cuda.synchronize()
                if mid.dtype != want_mid.dtype or not torch.equal(mid, want_mid):
                    raise AssertionError(f"{name}: phase_stream_v differs from its plain version")
                compare(f"{precision} phase_stream_h alone {name}", rp.stream_h_call(pops, mid),
                        rp.stream_h_reference(want_mid, pops.plan, precision, out[1]), "exact")
    pairs = {k[2] for k in reached if k[1]}
    print(f"  v1 instantiations reached: {len(reached)}; compile-time window pairs "
          f"{sorted(pairs)}", flush=True)
    built = {(nv, dv, nh, dh) for (nv, dv), (nh, dh) in rp.WINDOW_PAIRS}
    if pairs != built:
        raise AssertionError(f"the sweep missed window pairs {built - pairs}")
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
    refs64 = {"linear": ref64}  # phase 15 holds the streamed frames to them too
    del outs, ref64
    torch.cuda.empty_cache()

    # ---- 5. times
    print("== 5. times at 4K->8K (3 planes, CUDA events, mean of 20 after 3 warm-up; "
          "order plain, kernel, kernel, plain)", flush=True)
    kernels = []
    frame = bound(cfgs["fp32"], 3)  # the same bytes and taps for every 4K->8K config
    print(f"  bound: {frame['bytes'] / 1e6:.1f} MB at {HBM_TBPS} TB/s, "
          f"{frame['flops'] / 2e9:.2f} G multiply-adds at {FP32_PEAK_TFLOPS} TFLOP/s: "
          f"{frame['bound_ms']:.4f} ms by {frame['bound_by']}", flush=True)

    def rate(ms: float) -> str:
        gbs = frame["bytes"] / (ms * 1e-3) / 1e9
        return (f"{gbs:.0f} GB/s of the frame's {frame['bytes'] / 1e6:.1f} MB "
                f"({gbs / (HBM_TBPS * 1e3):.3f} of {HBM_TBPS} TB/s, "
                f"{ms / frame['bound_ms']:.1f}x the bound)")

    for p, cfg in cfgs.items():
        ops = rc.FusedOps(cfg, "cuda")
        plan = ops.plan

        def plain_fn():
            return rc.fused_resample_reference(planar, plan, p, cfg.out_shape)

        def kernel_fn():
            return rc.fused_call(ops, planar)

        runs = [cuda_time_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
        plain_ms, kernel_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        print(f"  {p}: kernel {runs[1]:.4f} / {runs[2]:.4f} ms/frame, plain version "
              f"{runs[0]:.4f} / {runs[3]:.4f} ms/frame; kernel {rate(kernel_ms)} [{smi}]",
              flush=True)
        kernels.append(entry(ops.kernel, "fused_resample.cu",
                             "lanczos_tpu/ops/resample_pallas.py:849", counts[ops.kernel],
                             errs[p], kernel_ms, plain_ms, frame))

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
    refs64["dering"] = f64["dering"][1].result()
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
              f"plain version {t[0]:.4f} / {t[3]:.4f} ms/frame; kernel {rate(kernel_ms)} "
              f"[{smi}]", flush=True)
        if name == "fp32 width-first dering":
            continue  # a path, not a kernel of its own
        kernels.append(entry(
            ops.kernel,
            "shift_resample.cu" if ops.shift is not None else "fused_resample.cu",
            "lanczos_tpu/ops/resample_pallas.py:" + ("779" if ops.shift is not None else "849"),
            launched, err, kernel_ms, plain_ms, frame))

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
            pops = ops.phase
            torch.cuda.synchronize()
            reset_counts()
            if via == "pallas":
                y = lanczos_torch.upscale(xin, out_shape=out, a=3, precision=p,
                                          backend="pallas")
            else:
                y = rc.resample_2d_cuda(xin, ops)
            torch.cuda.synchronize()
            n = read_counts()
            print(f"  {p} {name} ({pops.design}: {', '.join(pops.kernels)}; layout "
                  f"{pops.layout}): launches {n}", flush=True)
            if n != {k: 1 for k in pops.kernels}:
                raise AssertionError(
                    f"{name}: expected one launch each of {pops.kernels}, got {n}")
            if tuple(y.shape) != out + (3,) or y.dtype != torch.uint8 or not y.is_cuda:
                raise AssertionError(f"{name}: got {tuple(y.shape)} {y.dtype} {y.device}")
            want = plain_version(planar_in, ops).permute(1, 2, 0)
            err, _ = compare(f"{p} {name} vs plain version", y, want, "exact")
            # the generic design forced (the kernel v1 had first), through the same entry
            gen = rc.FusedOps(cfg, "cuda", variant="v1", design="generic")
            reset_counts()
            yg = rc.resample_2d_cuda(xin, gen)
            torch.cuda.synchronize()
            if read_counts() != {gen.kernel: 1}:
                raise AssertionError(f"{name}: forced generic launched {read_counts()}")
            compare(f"{p} {name} forced generic (tiles {gen.phase.layout}) vs plain version",
                    yg, want, "exact")
            errs_ab = None
            if pops.design == "stream":  # each of the two kernels against its own
                mid = rp.stream_v_call(pops, planar_in)
                want_mid = rp.stream_v_reference(planar_in, pops.plan, p, out[0])
                torch.cuda.synchronize()
                err_v = float((mid.float() - want_mid.float()).abs().max())
                print(f"  {p} {name}: phase_stream_v vs its plain version max|d|={err_v:g} "
                      f"({'ok' if err_v == 0 else 'FAIL'})", flush=True)
                if mid.dtype != want_mid.dtype or err_v != 0:
                    raise AssertionError(f"{name}: phase_stream_v differs from its plain version")
                err_h, _ = compare(
                    f"{p} {name}: phase_stream_h vs its plain version",
                    rp.stream_h_call(pops, mid),
                    rp.stream_h_reference(want_mid, pops.plan, p, out[1]), "exact")
                errs_ab = (err_v, err_h)
                del mid, want_mid
            v1_runs.append((name, p, ops, gen, planar_in, y.cpu().numpy(), ref, err, errs_ab))
            del y, yg, want
    for name, p, _, _, _, y, ref, _, _ in v1_runs:
        compare(f"{p} {name} vs float64 gather", y, ref.result(), p)
    print(f"  float64 numpy gather references (3, in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pool.shutdown()
    torch.cuda.empty_cache()

    # ---- 9. v1 times
    print("== 9. v1 times (3 planes, CUDA events, mean of 20 after 3 warm-up; order "
          "plain, generic, kernel, kernel, generic, plain)", flush=True)
    v1_entries = {}

    def v1_entry(kernel, err, ms, plain_ms, bnd, earlier):
        # the first shape that launches a kernel gives its times and its bound
        e = v1_entries.setdefault(kernel, dict(
            entry(kernel, "phase_resample.cu", "lanczos_tpu/ops/resample_pallas.py:687", 0, 0,
                  ms, plain_ms, bnd), earlier_ms=earlier))
        e["launches"] += 1
        e["max_abs_err"] = max(e["max_abs_err"], err)

    for name, p, ops, gen, planar_in, _, _, err, errs_ab in v1_runs:
        pops = ops.phase

        def kernel_fn():
            return rc.upscale_planar(planar_in, ops)

        def generic_fn():
            return rc.upscale_planar(planar_in, gen)

        def plain_fn():
            return plain_version(planar_in, ops)

        t = [cuda_time_ms(f) for f in (plain_fn, generic_fn, kernel_fn, kernel_fn, generic_fn,
                                       plain_fn)]
        ms, gen_ms, plain_ms = (t[2] + t[3]) / 2, (t[1] + t[4]) / 2, (t[0] + t[5]) / 2
        bnd = bound(ops.cfg, 3)
        print(f"  {p} {name} ({pops.design}): kernel {t[2]:.4f} / {t[3]:.4f} ms/frame, "
              f"generic design forced {t[1]:.4f} / {t[4]:.4f}, plain version {t[0]:.4f} / "
              f"{t[5]:.4f} [{smi}]", flush=True)
        print(f"    bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
              f"({bnd['bytes'] / 1e6:.1f} MB, {bnd['flops'] / 2e9:.2f} G multiply-adds): "
              f"{ms / bnd['bound_ms']:.1f}x now, {gen_ms / bnd['bound_ms']:.1f}x generic; "
              f"{bnd['bytes'] / (ms * 1e-3) / 1e9:.0f} GB/s", flush=True)
        if ms > gen_ms:
            raise AssertionError(
                f"{name}: the {pops.design} design ({ms:.4f} ms) is slower than the generic "
                f"one ({gen_ms:.4f} ms): the selector must send this shape there")
        v1_entry(gen.kernel, err, gen_ms, plain_ms, bnd, gen_ms)
        if errs_ab is None:
            v1_entry(pops.kernels[0], err, ms, plain_ms, bnd, gen_ms)
            continue
        # the streamed design's two kernels, each alone, each with its own bound: the
        # intermediate (nc, OH, W) is written once by the first and read once by the second
        plan, (ih, iw), (oh, ow) = pops.plan, ops.cfg.in_shape, ops.cfg.out_shape
        mid = rp.stream_v_call(pops, planar_in)
        want_mid = rp.stream_v_reference(planar_in, plan, p, oh)
        mid_bytes = 3 * oh * iw * mid.element_size()
        halves = [
            (pops.kernels[0], errs_ab[0], lambda: rp.stream_v_call(pops, planar_in),
             lambda: rp.stream_v_reference(planar_in, plan, p, oh),
             3 * ih * iw + mid_bytes, 2.0 * 3 * oh * iw * 2 * plan.v.support),
            (pops.kernels[1], errs_ab[1], lambda: rp.stream_h_call(pops, mid),
             lambda: rp.stream_h_reference(want_mid, plan, p, ow),
             mid_bytes + 3 * oh * ow, 2.0 * 3 * oh * ow * 2 * plan.h.support),
        ]
        for kernel, kerr, kfn, pfn, nbytes, flops in halves:
            tt = [cuda_time_ms(f) for f in (pfn, kfn, kfn, pfn)]
            t_b = nbytes / (HBM_TBPS * 1e12) * 1e3
            t_f = flops / (FP32_PEAK_TFLOPS * 1e12) * 1e3
            kb = dict(bound_ms=max(t_b, t_f), bound_by="bytes" if t_b >= t_f else "operations")
            print(f"    {kernel} alone: {tt[1]:.4f} / {tt[2]:.4f} ms, its plain version "
                  f"{tt[0]:.4f} / {tt[3]:.4f}; bound {kb['bound_ms']:.4f} ms by "
                  f"{kb['bound_by']} ({nbytes / 1e6:.1f} MB, {flops / 2e9:.2f} G "
                  f"multiply-adds)", flush=True)
            v1_entry(kernel, kerr, (tt[1] + tt[2]) / 2, (tt[0] + tt[3]) / 2, kb, gen_ms)
        del mid, want_mid
    kernels += list(v1_entries.values())
    del v1_runs
    torch.cuda.empty_cache()

    # ---- 10. the ablation harness
    print("== 10. the dense fused kernel's ablation harness: 12 planes 2160x3840 -> "
          f"4320x7680, tile 64, every variant; ms per 3-plane frame [{smi}]", flush=True)
    specs = [af.parse_spec(f"64:{v}") for v in af.VARIANTS]
    himg = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (af.PLANES,) + FRAME, dtype=np.uint8)).cuda()
    torch.cuda.synchronize()
    reset_counts()
    results = af.run(specs, himg, log=lambda line: print("  " + line, flush=True))
    torch.cuda.synchronize()
    n = read_counts()
    dense_plan = rc.plan_at(cfgs["fp32"], 64)
    earlier = {}
    for r in results:
        name = f"ablate_fused_{r['variant']}"
        if not r["ok"]:
            raise AssertionError(
                f"{r['spec']}: differs from its dense plain version, or from the "
                "production kernel by more than the fused kernel's limits")
        if n.get(name, 0) < 1:
            raise AssertionError(f"{name} was not launched by the harness")
        stage = r["variant"].removeprefix("f32")
        if stage == "full":  # the production kernel's earlier, dense design
            earlier["fp32" if r["variant"] == "f32full" else "bf16"] = r["ms"]
            tflops = dense_flops(dense_plan, 3) / (r["ms"] * 1e-3) / 1e12
            print(f"  {r['spec']}: {tflops:.2f} TFLOP/s dense "
                  f"({tflops / FP32_PEAK_TFLOPS:.3f} of the {FP32_PEAK_TFLOPS} fp32 peak), "
                  f"{rate(r['ms'])}; the production kernel beside it {r['prod_ms']:.4f} ms",
                  flush=True)
        kernels.append(entry(
            name, "ablate_fused.cu",
            "tools/ablate_mxu.py:" + ("289" if stage == "swpipe" else "37"), n[name],
            r["plain_max_abs_diff"], r["ms"], r["plain_ms"], frame))
    for k in kernels:  # the redesigned kernels beside what they replaced
        if k["name"].startswith("fused_resample_"):
            k["earlier_ms"] = earlier["fp32" if "_fp32" in k["name"] else "bf16"]
        elif k["name"] == "shift_resample":
            k["earlier_ms"] = None  # its earlier design is no longer built: PERF.md has its time
    del himg

    bit_exact_and_float_paths(img, x, smi)
    streaming_and_video(img, x, smi, refs64, kernels)
    sharding(img, x, smi, kernels)

    left = stop_leftovers()
    print(f"  processes the run left running: {len(left)} (stopped)", flush=True)
    print(f"  chip_smoke took {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    adopt_orphans()
    try:
        main()
    finally:  # on every exit, a failed phase's too
        stop_leftovers(sys.stderr)
