"""Smoke test of the PyTorch/CUDA port (``lanczos_torch``) on one GPU, and on
every visible GPU for the sharded paths.

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
   seeds drawn as ``hwcert.py`` draws its exact seeds (the port's harness
   ``lanczos_torch.tools.hwcert.draw_exact``) (plus ``hls`` at
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
   ``Mesh.local(spread(8, cards), (2, 4))`` (position i on card i mod the
   cards visible: all 8 on one card, each rows ring across the cards where
   there are several) in fp32, bf16, with dering and with the quantized
   intermediate, channel groups on and off, each with its launch count (R
   a frame, 2R with channel groups) and byte-equal to ``Upscaler(cfg)`` on
   the card;
19. the other sharded paths on (1, 4) at 4K→8K: gather (drop edges),
   shift, ``hls`` a=2, ``c_oracle`` a=3 and uint16, each byte-equal to the
   same path on one device;
20. ``ShardedStreamingUpscaler`` (R = 4, ``chunk_rows=1024``) on the
   17280×3840 frame, byte-equal to ``StreamingUpscaler``; its wall time
   into page-locked memory (8 calls, each between synchronizing every
   card: the median and band of the last 7, and all 8 in order) and the
   peak device memory of each card;
21. ``VideoUpscaler(mesh=(2, 2))`` on 16 4K frames, byte-equal to
   ``Upscaler`` a frame;
22. a one-rank NCCL process group: ``Mesh.distributed`` running the fused
   sharded path, equal to the local mesh; ``measure_ici_bw`` must raise
   where the rows ring has one card, and measures it where it has several;
23. times for R = 1, 2, 4, 8: each shard's kernel (direct library calls,
   timed by events on its card), the halo copies and the sharded frame
   (events on one card; the host clock between synchronizing every card
   where the mesh spans several), and ``ici_halo_model`` for 4 NVLink
   cards fed this run's frame time (a model, printed as one);
24. the CLI at full width: ``python -m lanczos_torch in.png out.png
   --scale 2/1 --no-psnr`` in its own process on a seeded 4K PNG written
   by the port's ``write_png``, fp32 and ``--precision bf16``, each with
   the launches of its process (one fused kernel) and its output, decoded
   by the port, byte-equal to ``Upscaler(cfg)`` on the card; the wall split
   of one run in this process (decode, upload, kernel by events,
   readback, encode); ``--bench 20`` beside phase 13's ``Upscaler`` time;
   last, the same frame as a JPEG (the port's encoder, run in a process of
   its own meanwhile, and its decoder), ``--info`` and a run byte-equal to
   ``Upscaler`` on the decoded frame;
25. ``--backend pallas`` through ``cli.main``: an 8K PNG to 480×270 (the v1
   ``stream`` kernels) and a 480×480 PNG at ``--a 215 --scale 2/1`` (kernel
   2), each with its launches and byte-equal to ``Upscaler(cfg,
   backend="pallas")``;
26. the goldens of ``tests/data/`` through the CLI (``hls`` and
   ``c_oracle`` at the scales and supports of ``tests/test_golden.py``; its
   bit precisions 6 and 10 through ``Upscaler``: the CLI has no such
   flag), byte for byte; the default invocation (RMS/PSNR on) at
   1080p→4K, its printed RMS equal to ``rms_error`` against
   ``c_oracle_upscale`` in this process;
27. files in, files out: 4 seeded 4K PNG frames through ``FrameLoader`` →
   ``VideoUpscaler`` → ``FrameWriter`` (4 launches), each output byte-equal
   to ``Upscaler``, frames/s beside the loader and the writer alone; an
   8-frame 4:2:0 ``.y4m`` through the CLI byte-equal to ``upscale_y4m``;
   ``examples_torch/01``–``06``, each in a process of its own, started
   with phase 24's CLI runs (03 and 06 on 8 positions of the one card), 01
   and 02 byte-equal to the same calls here; ``entry()`` (one launch) and
   ``dryrun_multichip(8, ["cuda:0"] * 8)``;
28. certification: ``python -m lanczos_torch.tools.hwcert``'s ``main`` in
   this process with ``hwcert.py``'s defaults but no bit-exact seeds (phase
   11 holds them): 40 drawn configs through ``backend="pallas"`` (each has a
   fused plan) and, where kernel 2 or v1 takes it, through that kernel too,
   against float64 gathers, 6 anisotropic, 6 uint16 and a ``.y4m`` in each
   of 420p10, 422p12 and mono; its summary line, the launches (each of the
   three kernel families at least once) and the wall time, and every failed
   row; 55 rows, none failed;
29. constant planes (``lanczos_torch.tools.constant_planes``): the plane of
   137 at 24×20, 2/1, a=3 (``tests/test_invariants.py``) exactly 137
   through the fused kernel, kernel 2 and v1 (its own plan at 2/1); then
   one 4K plane of each value 0..255 to 8K through each family, each plane
   identical bytes to the family's plain version on the card, and the count
   of values with a pixel at v − 1 equal to the count the plain passes give
   on the CPU (over each plane's distinct rows);
30. the non-Lanczos filters: ``mitchell``, ``catmull_rom``, ``triangle``
   and ``box`` at a = 2 and 3 through the fused kernel at 4K→8K (fp32,
   bf16, dering with the quantized intermediate), kernel 2 at 4K→8K
   (dering) and v1 at 8K→480×270 (``stream``) and 1440p→4K (``window``):
   each with its launches, identical bytes to its plain version, within
   the contract of ``backend="xla"`` (the reference's fp32 gather,
   ``hwcert.py``'s yardstick), within the contract's LSB bound of a float64
   gather, and its time beside its bound (mitchell and catmull_rom at
   support 2, whatever a);
31. the benchmark scripts as a user runs them, each a process of its own:
   ``python -m lanczos_torch.tools.bench`` (the 4K→8K headline, batch-4
   planar, fp32 and bf16) and ``python -m lanczos_torch.tools.bench_suite
   --bf16 --mesh 4 --devices 8 --frames 16 --iters 10`` (every row of
   ``BASELINE.json``'s table, the stream, the mesh and video rows on 8
   positions of the one card); each row checked by the script against
   ``backend="xla"`` (or one device) before it is timed; their JSON lines
   echoed, a missing row, a row with no value or a non-zero exit failing
   the phase; the headline beside phase 5's kernel time ×4 (the batch);
   the fused kernels' launches in the rows' checked and timed calls (the
   rows' ``launches``) as ``bench_launches``.
32. across cards, where two or more are visible (on one card it prints
   that it did not run): ``python -m lanczos_torch.tools.multicard`` as
   processes, ``--local`` (the peer access matrix and copy rates, then one
   process over the cards on every (data, rows) mesh shape, every case
   byte-equal to one card, with frame, halo, ring and video times), ``--ranks 2``,
   ``--ranks N`` and ``--ranks 1`` (NCCL ranks, one a card);
   ``upscale(mesh=)`` on (1, N) with its launches and ``upscale_y4m(mesh=)``,
   each byte-equal to one card; ``dryrun_multichip(N, cuda:0..N-1)``;
   examples 03 and 06 with ``--n N``; ``bench_suite --mesh N --devices N
   --frames 16``, whose mesh and video rows must be measured on real cards
   (``virtual_mesh`` false, ``measured_eff`` and ``ici_bw`` set).  Every
   step runs; the phase fails at its end if one failed.

The host references run on threads.  Phases 24, 27, 31 and 32 start processes
(the CLI, the JPEG encoder, the examples, the benchmark scripts) and wait
for each.  The run
makes itself the subreaper of whatever it starts, and at its end, and on
any failure, stops each process of the run still alive and names it.

Limits: fp32 ≤ 1 LSB on ≤ 1% of pixels (the quantized intermediate ≤ 2
LSB: one flipped intermediate value spreads over the taps); bf16 ≤ 3 LSB
on ≤ 50% of pixels; every kernel (the fused kernel, kernel 2, the v1
kernels: each tap one ``fmaf`` in both) and its plain version identical
bytes, and each ablation kernel and its dense plain version; a streamed frame ≤ 1 LSB from the
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
value and pass) over the 67 TFLOP/s SIMT fp32 peak
(``lanczos_torch.utils.profiling.kernel_bound``); ``library_ms`` is
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

# the H100's peak rates (NVIDIA's data sheet, SXM at 700 W: SIMT fp32 and
# device memory), the kernels' bound and the float64 reference
from lanczos_torch.parallel.mesh import spread  # positions over the visible cards
from lanczos_torch.ref.gather import gather_f64
from lanczos_torch.utils.profiling import FP32_PEAK_TFLOPS, HBM_TBPS, bound_of, kernel_bound
from lanczos_torch.utils.timing import sync_cards  # every card: a sharded call spans them

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50), "quant": (2, 0.01), "exact": (0, 0.0),
          "float": (1e-3, 1.0), "1 LSB": (1, 1.0), "2 LSB": (2, 1.0), "3 LSB": (3, 1.0)}
BOUND_ONLY = {"fp32": "1 LSB", "quant": "2 LSB", "bf16": "3 LSB"}  # a limit's LSB bound alone
TALL = (17280, 3840)  # eight 4K frames' rows: the frame that makes streaming real
FRAME = (2160, 3840)  # the main path's input, 4K; output 2x each way
# a rational scale (563/540 by 667/640) only the block path takes
BLOCK_CASE = ((1080, 1920), (1126, 2001))
T0 = time.perf_counter()


def compare(name: str, got, want, precision: str) -> tuple[int, float]:
    """Max |Δ| and the share of differing pixels; raises past the limits.
    A uint8 frame on the card is compared there (``want`` uploaded), any
    other on the host."""
    if getattr(got, "is_cuda", False) and str(got.dtype) == "torch.uint8":
        from lanczos_torch.tools.bench import diff

        mx, frac = diff(name, got, want)
    else:
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
    bit-exact seeds, drawn by the certification harness's ``draw_exact``
    (odd seeds ``hls``, even ``c_oracle``), plus two ``hls`` seeds at P = 6
    and P = 10."""
    from lanczos_torch.tools.hwcert import draw_exact

    out = []
    for seed, bp in [(s, 8) for s in range(10)] + [(11, 6), (13, 10)]:
        profile, cfg, img = draw_exact(seed)
        profile, (h, w), (n, d), a = profile.value, cfg.in_shape, cfg.scale_h, cfg.a
        name = f"{profile} seed {seed} {h}x{w} {n}/{d} a={a}" + (
            f" P={bp}" if profile == "hls" else "")
        out.append((name, profile, (h, w), (n, d), a, bp, img))
    return out


def bit_exact_and_float_paths(img: np.ndarray, x, smi: str) -> dict:
    """Phases 11–13: the bit-exact profiles, the float paths and their
    times, on ``x`` (``img`` on the card); returns phase 13's ms/frame by
    name."""
    import torch

    import lanczos_torch
    from lanczos_torch.utils.timing import cuda_time_ms

    # ---- 11. the bit-exact profiles
    print("== 11. bit-exact profiles on the card vs the host oracles", flush=True)
    from lanczos_torch.models.upscaler import Upscaler, _shift_eligible
    from lanczos_torch.ref._native import native_lib
    from lanczos_torch.ref.oracle import c_oracle_upscale
    from lanczos_torch.tools.hwcert import exact_oracle

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
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            y = up(xin)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            want_dt = torch.float32 if im.dtype.kind == "f" else getattr(torch, im.dtype.name)
            if y.device != x.device or y.dtype != want_dt:
                raise AssertionError(f"{name}: got {y.dtype} on {y.device}")
            compare(f"{name} (backend {backend!r} took {took}, peak {peak:.2f} GiB) vs "
                    "float64 gather", y, refs[key].result(), lim)
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
    times = {}
    for name, up, xin, took in timed:
        ms = times[name] = cuda_time_ms(up, xin)
        print(f"  {name} ({took}): {ms:.4f} ms/frame", flush=True)
        torch.cuda.empty_cache()
    del timed
    return times


def wall_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean host milliseconds per call of ``fn``, which must end with the
    device idle (the streaming and video entry points wait for their last
    readback); every card is synchronized before and after."""
    for _ in range(warmup):
        fn()
    sync_cards()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync_cards()
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
                    "exact")
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

    cards = torch.cuda.device_count()

    def mesh_of(shape):
        return Mesh.local(spread(shape[0] * shape[1], cards), shape)

    def where(n: int) -> str:
        return f"{n} positions on {min(n, cards)} card{'s' if min(n, cards) > 1 else ''}"

    def identical(name: str, got, want) -> None:
        same = got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
        print(f"  {name}: {'identical' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{name}: not byte-equal to the single-device result")

    # ---- 18. the sharded fused path at full width
    print("== 18. sharded fused path: 2 frames 2160x3840x3 -> 4320x7680x3 on "
          f"Mesh.local({spread(8, cards)}, (2, 4)): {where(8)}", flush=True)
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
    print(f"== 19. the other sharded paths at 4K->8K on Mesh.local({spread(4, cards)}, (1, 4))",
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
    print(f"== 20. ShardedStreamingUpscaler (R = 4, chunk_rows=1024) on {TALL[0]}x{TALL[1]}x3, "
          f"{where(4)}", flush=True)
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
    ring = sorted({str(d) for d in ssm._ring})
    for d in ring:
        torch.cuda.reset_peak_memory_stats(d)
    # each call on its own between synchronizing every card: the first one
    # apart, the median and band of the rest
    calls = [wall_ms(lambda: ssm(tall), iters=1, warmup=0) for _ in range(8)]
    band = sorted(calls[1:])
    peaks = ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.3f}" for d in ring)
    print(f"  ssm(tall) into page-locked memory, ms wall a frame ({TALL[0]}x{TALL[1]}x3 -> "
          f"{2 * TALL[0]}x{2 * TALL[1]}x3): median {band[len(band) // 2]:.1f} of {len(band)} "
          f"calls after the first, band {band[0]:.1f}-{band[-1]:.1f}; in call order "
          f"{', '.join(f'{t:.1f}' for t in calls)}; peak device memory, GiB: {peaks} [{smi}]",
          flush=True)

    # ---- 21. video on a mesh
    print(f"== 21. VideoUpscaler(mesh=Mesh.local({spread(4, cards)}, (2, 2))): 16 frames "
          "4K->8K", flush=True)
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
        dmesh = Mesh.distributed((2, 4), spread(8, cards))
        print(f"  {dmesh}, backend {dist.get_backend()}", flush=True)
        cfg = profile(FRAME, scale=(2, 1), a=3)
        reset_counts()
        got = Sharded(cfg, dmesh)(frames2)
        torch.cuda.synchronize()
        print(f"  launches {read_counts()}", flush=True)
        identical("fused path on the distributed mesh vs the local mesh", got,
                  Sharded(cfg, mesh24)(frames2))
        if dmesh.distinct_on("rows", (0, 0)) >= 2:  # the rows ring spans cards
            print(f"  measure_ici_bw on the rows ring of {where(4)}: "
                  f"{multihost.measure_ici_bw(dmesh) / 1e9:.1f} GB/s a direction", flush=True)
        else:
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
    print(f"== 23. sharding times on {cards} card{'s' if cards > 1 else ''}, 4K->8K fp32, one "
          f"frame [{smi}]", flush=True)
    cfg = profile(FRAME, scale=(2, 1), a=3)
    whole_ops = rc.FusedOps(cfg, dev)
    planar = x.permute(2, 0, 1).contiguous()
    launch = _build.library().lanczos_fused_resample

    def kernel_ms(call, device) -> float:
        """Device ms of the one launch ``call`` makes on ``device``, repeated
        as direct library calls (the wrapper's host cost kept out)."""
        with torch.cuda.device(device):
            args, out = pk.launch_args("lanczos_fused_resample", call)
            ms = pk.time_ms(launch, args, iters=50)
        del out  # the launches wrote into it
        return ms

    whole_ms = kernel_ms(lambda: rc.fused_call(whole_ops, planar), dev)
    print(f"  whole-frame kernel (50 direct calls; event): {whole_ms:.4f} ms", flush=True)
    frame_ms = {}
    for R in (1, 2, 4, 8):
        mesh = mesh_of((1, R))
        # events see one card's stream: a mesh over several cards is timed by
        # the host clock between synchronizing every card
        one_card = len({str(mesh.device(p)) for p in mesh.positions()}) == 1
        clock = "event" if one_card else "wall"

        def ms_of(fn):
            return cuda_time_ms(fn) if one_card else wall_ms(fn, iters=20)

        sh = Sharded(cfg, mesh, overlap=False)
        ext = halo_exchange_rows(mesh, sh._blocks(x1), sh.halo)
        shard_ms = []
        for p, e in ext.items():
            pl, t = e[0].permute(2, 0, 1).contiguous(), sh._tables(e.device)
            shard_ms.append(kernel_ms(lambda: rc.fused_call(t.fused, pl, wv=t.wv[p[1]]),
                                      e.device))
        blocks = sh._blocks(x1)
        halo_ms = ms_of(lambda: halo_exchange_rows(mesh, blocks, sh.halo))
        serial_ev = ms_of(lambda: sh(x1))
        serial_wall = wall_ms(lambda: sh(x1), iters=20)
        over = Sharded(cfg, mesh)
        over_ev, over_wall = ms_of(lambda: over(x1)), wall_ms(lambda: over(x1), iters=20)
        frame_ms[R] = serial_ev
        halo_bytes = sh.halo_spec()["bytes"]
        print(f"  R={R} ({where(R)}): shard kernels (direct calls; event, each on its card) "
              f"{', '.join(f'{m:.4f}' for m in shard_ms)} ms, sum {sum(shard_ms):.4f} "
              f"({sum(shard_ms) / whole_ms:.2f}x the whole-frame kernel); halo exchange of the "
              f"frame ({clock}) {halo_ms:.4f} ms, {halo_bytes} B a direction a shard; sharded "
              f"frame serial {serial_ev:.4f} ms {clock} / {serial_wall:.4f} ms wall "
              f"({R} launches: {serial_wall / R:.4f} ms wall a launch), overlapped (2 channel "
              f"groups) {over_ev:.4f} / {over_wall:.4f} ({2 * R} launches)", flush=True)
    model = multihost.ici_halo_model(cfg, 4, whole_ms * 1e-3)
    print(f"  MODEL, not a measurement: ici_halo_model for 4 cards of one NVLink node "
          f"(NVLink 4 at the 450 GB/s a direction of NVIDIA's specification), fed this run's "
          f"whole-frame kernel time {whole_ms:.4f} ms: {json.dumps(model)}", flush=True)


ROOT = os.path.dirname(os.path.abspath(__file__))
# ``python -m lanczos_torch`` run as ``-m`` runs it (runpy), which then prints
# the kernel launches of its process on exit: the counts of a CLI subprocess
COUNTED_CLI = (
    "import atexit, json, runpy, sys\n"
    "def launches():\n"
    "    from lanczos_torch.ops import resample_cuda as rc, resample_phase_cuda as rp\n"
    "    from lanczos_torch.ops import resample_shift_cuda as rs\n"
    "    n = {k: v for m in (rc, rs, rp) for k, v in m.launches.items() if v}\n"
    "    print('LAUNCHES ' + json.dumps(n), flush=True)\n"
    "atexit.register(launches)\n"
    "sys.argv[0] = 'lanczos_torch'\n"
    "runpy.run_module('lanczos_torch', run_name='__main__', alter_sys=True)\n"
)
# 4K PNG frames through FrameLoader -> VideoUpscaler -> FrameWriter: each 8K
# PNG costs the host's zlib seconds (PERF.md section 5), so one wave of the
# writer's 4 encode threads, not two
FILES = 4
GOLDENS = [  # tests/test_golden.py:28-56 that the CLI reaches (it has no bit-precision flag)
    ("c_oracle", "2/1", 2, "golden_c_oracle_2x_a2.png"),
    ("c_oracle", "2/1", 3, "golden_c_oracle_2x_a3.png"),
    ("c_oracle", "3/2", 2, "golden_c_oracle_3over2_a2.png"),
    ("hls", "2/1", 2, "golden_hls_2x_a2.png"),
    ("hls", "2/1", 3, "golden_hls_2x_a3.png"),
    ("hls", "3/2", 2, "golden_hls_3over2_a2.png"),
]


def start(cmd: list) -> subprocess.Popen:
    """A process of the checkout's Python on ``cmd``, from the checkout's
    root, with the checkout importable."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.Popen([sys.executable] + [str(c) for c in cmd], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, name: str, timeout: float = 300, echo: bool = False) -> str:
    """``proc``'s standard output; raises, with the end of its output and of
    its errors, if it failed; with ``echo``, prints its errors' lines first."""
    out, err = proc.communicate(timeout=timeout)
    if echo:
        for line in err.splitlines():
            print(f"  {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
    return out


def finish_timed(proc: subprocess.Popen, name: str, t0: float) -> tuple[str, float]:
    """``finish`` and the seconds from ``t0`` to the process's end."""
    out = finish(proc, name)
    return out, time.perf_counter() - t0


def launches_of(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("LAUNCHES ")][-1][9:])


def cli_in_process(argv: list) -> tuple[str, dict]:
    """``lanczos_torch.cli.main(argv)`` in this process: its standard output
    and the kernels it launched."""
    import contextlib
    import io

    import torch

    from lanczos_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    return buf.getvalue(), counts


def equal_bytes(name: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or not np.array_equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}, "
                             f"{n} values differ")
    print(f"  {name}: identical bytes {got.shape}", flush=True)


def expect_launches(name: str, counts: dict, want: dict) -> None:
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    print(f"  {name}: launches {counts}", flush=True)


def cli_and_files(img: np.ndarray, x, smi: str, upscaler_ms: float) -> None:
    """Phases 24–27: the CLI, the image codecs, the loader and writer, the
    examples and the entry points, on ``img`` (``x`` on the card)."""
    import torch

    import lanczos_torch
    from lanczos_torch.entry import dryrun_multichip, entry
    from lanczos_torch.io import (encode_gif, read_image, read_png, write_image, write_png,
                                  write_y4m)
    from lanczos_torch.io._native import native_paths
    from lanczos_torch.io.loader import FrameLoader, FrameWriter
    from lanczos_torch.models.upscaler import Upscaler
    from lanczos_torch.ref.oracle import c_oracle_upscale
    from lanczos_torch.utils.metrics import rms_error

    def cfg_of(shape, a=3, **kw):
        return lanczos_torch.ResampleConfig.from_profile("precise", shape, a=a, **kw)

    def on_card(model, im):
        return model(torch.from_numpy(im).cuda()).cpu().numpy()

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(4) as host:
        path = lambda name: os.path.join(tmp, name)  # noqa: E731

        # ---- 24. the CLI at full width
        print(f"== 24. python -m lanczos_torch at 4K->8K (PNG in, PNG out) [{smi}]", flush=True)
        t24 = time.perf_counter()
        print(f"  native codec loops: {native_paths()} (False: the NumPy path ran)", flush=True)
        t0 = time.perf_counter()
        write_png(path("4k.png"), img)
        print(f"  write_png of the 4K frame (level 6): {time.perf_counter() - t0:.3f} s",
              flush=True)
        cfgs = {p: cfg_of(FRAME, scale=(2, 1), precision=p) for p in ("fp32", "bf16")}
        models = {p: Upscaler(c) for p, c in cfgs.items()}
        want = {p: m(x).cpu().numpy() for p, m in models.items()}
        # where one run's wall time goes, step by step as cli.main takes them
        # (the model warm: its plan and the kernels' library exist)
        split = {}
        t0 = time.perf_counter()
        im = read_image(path("4k.png"))
        split["decode"] = time.perf_counter() - t0
        equal_bytes("read_image(write_png(frame))", im, img)
        t0 = time.perf_counter()
        xd = torch.from_numpy(im).cuda()
        torch.cuda.synchronize()
        split["upload"] = time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        y = models["fp32"](xd)
        ev[1].record()
        torch.cuda.synchronize()
        split["kernel (host)"] = time.perf_counter() - t0
        split["kernel (events)"] = ev[0].elapsed_time(ev[1]) * 1e-3
        t0 = time.perf_counter()
        out = y.cpu().numpy()
        split["readback"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_image(path("split.png"), out)
        split["encode"] = time.perf_counter() - t0
        equal_bytes("in-process run vs Upscaler", out, want["fp32"])
        total = sum(v for k, v in split.items() if k != "kernel (events)")
        print("  wall split of one fp32 run (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in split.items()) + f"; total {total:.3f} s, the kernel "
            f"{split['kernel (events)'] / total:.5f} of it [{smi}]", flush=True)
        del xd, y

        t0 = time.perf_counter()
        bench = finish(start(["-m", "lanczos_torch", path("4k.png"), path("bench.bmp"),
                              "--scale", "2/1", "--no-psnr", "--bench", "20"]), "--bench 20")
        line = [ln for ln in bench.splitlines() if ln.startswith("bench:")]
        bench_ms = float(line[0].split()[1])
        print(f"  python -m lanczos_torch ... --bench 20 (alone, {time.perf_counter() - t0:.1f} s "
              f"wall): {line[0]!r}; phase 13's Upscaler fp32 4K->8K {upscaler_ms:.4f} ms/frame; "
              f"ratio {bench_ms / upscaler_ms:.3f} [{smi}]", flush=True)

        # the inputs of the later phases, on host threads; meanwhile, in
        # processes of their own, the JPEG encoder (Python a block), the six
        # examples and the two CLI runs below
        rng = np.random.default_rng(24)
        img8k = rng.integers(0, 256, (2 * FRAME[0], 2 * FRAME[1], 3), dtype=np.uint8)
        img480 = rng.integers(0, 256, (480, 480, 3), dtype=np.uint8)
        img1080 = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
        frames = [np.random.default_rng(270 + k).integers(0, 256, FRAME + (3,), dtype=np.uint8)
                  for k in range(FILES)]
        paths = [path(f"f{k}.png") for k in range(FILES)]
        planes = [(rng.integers(0, 256, FRAME, dtype=np.uint8),)
                  + tuple(rng.integers(0, 256, (FRAME[0] // 2, FRAME[1] // 2), dtype=np.uint8)
                          for _ in range(2)) for _ in range(8)]
        write_y4m(path("in.y4m"), planes, fps=(30, 1), colorspace="420jpeg")
        gif = rng.integers(0, 4, (4, 270, 480, 3), dtype=np.uint8) * 80
        with open(path("in.gif"), "wb") as f:
            f.write(encode_gif(gif, delays_cs=[4, 5, 6, 7]))
        write_png(path("1080.png"), img1080)
        jpeg_enc = start(["-c", "import sys, time; from lanczos_torch.io import read_image, "
                          "write_image; im = read_image(sys.argv[1]); t = time.perf_counter(); "
                          "write_image(sys.argv[2], im); print(time.perf_counter() - t)",
                          path("4k.png"), path("4k.jpg")])
        examples = {
            "01": ["01_image_upscale.py", path("1080.png"), path("e01.png")],
            "02": ["02_video_y4m.py", path("in.y4m"), path("e02.y4m")],
            "03": ["03_sharded_mesh.py", "--n", "8"],
            "04": ["04_streaming_tall_frame.py"],
            "05": ["05_gif_animation.py", path("in.gif"), path("e05")],
            "06": ["06_sharded_video_stream.py", "--n", "8"],
        }
        t_ex = time.perf_counter()
        waits = ThreadPoolExecutor(len(examples))
        ex_runs = {k: waits.submit(finish_timed,
                                   start([os.path.join(ROOT, "examples_torch", v[0])] + v[1:]),
                                   "examples_torch/" + v[0], t_ex)
                   for k, v in examples.items()}
        prep = [host.submit(write_png, path("8k.png"), img8k),
                host.submit(write_png, path("480.png"), img480)]
        prep += [host.submit(write_png, p, f) for p, f in zip(paths, frames)]
        oracle1080 = host.submit(c_oracle_upscale, img1080, 2160, 3840, 3)

        t0 = time.perf_counter()
        procs = {p: start(["-c", COUNTED_CLI, path("4k.png"), path(f"cli_{p}.png"), "--scale",
                           "2/1", "--no-psnr"] + (["--precision", "bf16"] if p == "bf16" else []))
                 for p in ("fp32", "bf16")}
        for p, proc in procs.items():
            outp = finish(proc, f"python -m lanczos_torch ({p})")
            print("  " + outp.splitlines()[0], flush=True)
            expect_launches(f"CLI {p}", launches_of(outp), {f"fused_resample_{p}": 1})
            equal_bytes(f"CLI {p} output vs Upscaler(cfg)(img) on the card",
                        read_png(path(f"cli_{p}.png")), want[p])
        print(f"  the two CLI runs, in parallel: {time.perf_counter() - t0:.1f} s wall", flush=True)
        del want
        print(f"  phase 24 (PNG): {time.perf_counter() - t24:.1f} s", flush=True)

        # ---- 25. --backend pallas through the CLI
        print("== 25. --backend pallas through the CLI: v1 (8K->480x270) and kernel 2", flush=True)
        t25 = time.perf_counter()
        for fut in prep[:2]:
            fut.result()
        for name, src, im, args, kw, kernels in (
            ("8K PNG --out-size 480x270", "8k.png", img8k, ["--out-size", "480x270"],
             dict(out_shape=(270, 480)), ("phase_stream_v_fp32", "phase_stream_h_fp32")),
            ("480x480 PNG --a 215 --scale 2/1", "480.png", img480,
             ["--a", "215", "--scale", "2/1"], dict(a=215, scale=(2, 1)), ("shift_resample",)),
        ):
            outp, counts = cli_in_process([path(src), path("p25.png"), "--backend", "pallas",
                                           "--no-psnr"] + args)
            print("  " + outp.strip(), flush=True)
            expect_launches(name, counts, {k: 1 for k in kernels})
            equal_bytes(f"CLI {name} vs Upscaler(cfg, backend='pallas')",
                        read_png(path("p25.png")),
                        on_card(Upscaler(cfg_of(im.shape[:2], **kw), backend="pallas"), im))
        print(f"  phase 25: {time.perf_counter() - t25:.1f} s", flush=True)

        # ---- 26. bit-exact goldens and the default invocation
        print("== 26. the goldens through the CLI on the card; the default invocation "
              "(RMS/PSNR on) at 1080p->4K", flush=True)
        t26 = time.perf_counter()
        data = os.path.join(ROOT, "tests", "data")
        small = read_png(os.path.join(data, "input_48x40.png"))
        for profile, scale, a, golden in GOLDENS:
            outp, counts = cli_in_process([os.path.join(data, "input_48x40.png"), path("g.png"),
                                           "--profile", profile, "--scale", scale, "--a", a])
            rms = [ln for ln in outp.splitlines() if ln.startswith("RMS")]
            with open(path("g.png"), "rb") as f, open(os.path.join(data, golden), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"CLI --profile {profile} --scale {scale} --a {a}: "
                                         f"the file differs from {golden}")
            print(f"  --profile {profile} --scale {scale} --a {a}: the bytes of {golden}; "
                  f"launches {counts}; {rms[0]}", flush=True)
        for bp, golden in ((6, "golden_hls_2x_a2_p6.png"), (10, "golden_hls_2x_a2_p10.png")):
            cfg = lanczos_torch.ResampleConfig.from_profile("hls", (48, 40), scale=(2, 1), a=2,
                                                            bit_precision=bp)
            equal_bytes(f"Upscaler hls bit_precision={bp} (no CLI flag) vs {golden}",
                        on_card(Upscaler(cfg), small), read_png(os.path.join(data, golden)))
        outp, counts = cli_in_process([path("1080.png"), path("o1080.png")])
        print("  " + outp.replace("\n", "\n  ").rstrip(), flush=True)
        expect_launches("default invocation 1080p->4K", counts, {"fused_resample_fp32": 1})
        rms = [ln for ln in outp.splitlines() if ln.startswith("RMS error vs fp64 oracle:")]
        mine = f"{rms_error(read_png(path('o1080.png')), oracle1080.result()):.4f}"
        if not rms or rms[0].split()[5] != mine:
            raise AssertionError(f"the CLI printed {rms}, rms_error in this process gives {mine}")
        print(f"  rms_error vs c_oracle_upscale in this process: {mine} (the same)", flush=True)
        print(f"  phase 26: {time.perf_counter() - t26:.1f} s", flush=True)

        # ---- the processes started in phase 24: the examples, the JPEG encoder
        print("== 27 (examples). examples_torch/01-06, each in a process of its own, started "
              "with phase 24's CLI runs (03 and 06 on 8 positions of the one card)", flush=True)
        for k, run in ex_runs.items():
            out, secs = run.result()
            print(f"  examples_torch/{examples[k][0]}: {secs:.1f} s wall; "
                  f"{out.strip().splitlines()[-1]}", flush=True)
        waits.shutdown()
        equal_bytes("example 01 vs Upscaler", read_png(path("e01.png")),
                    on_card(Upscaler(cfg_of((1080, 1920), scale=(2, 1))), img1080))
        lanczos_torch.upscale_y4m(path("in.y4m"), path("ref.y4m"), scale=(2, 1), a=3, batch=8)
        with open(path("e02.y4m"), "rb") as f, open(path("ref.y4m"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError("example 02 differs from upscale_y4m")
        print("  example 02: identical bytes to upscale_y4m", flush=True)

        print("== 24 (JPEG). the same 4K frame as a JPEG through the CLI", flush=True)
        t_enc = float(finish(jpeg_enc, "write_image(4k.jpg)", timeout=900))
        print(f"  write_image(.jpg) of the 4K frame (quality 90, in a process of its own): "
              f"{t_enc:.3f} s", flush=True)
        outp, counts = cli_in_process([path("4k.jpg"), "--info"])
        print("  --info: " + outp.strip(), flush=True)
        t0 = time.perf_counter()
        jpg = read_image(path("4k.jpg"))
        t_dec = time.perf_counter() - t0
        outp, counts = cli_in_process([path("4k.jpg"), path("jpg_out.bmp"), "--no-psnr"])
        expect_launches("CLI on the JPEG", counts, {"fused_resample_fp32": 1})
        equal_bytes("CLI on the JPEG (BMP out) vs Upscaler on its decoded frame",
                    read_image(path("jpg_out.bmp")), on_card(models["fp32"], jpg))
        print(f"  JPEG decode of the 4K frame: {t_dec:.3f} s; its PSNR against the frame "
              f"{20 * np.log10(255 / max(rms_error(jpg, img), 1e-12)):.2f} dB", flush=True)
        del jpg

        # ---- 27. files in, files out
        print(f"== 27. files in, files out: FrameLoader -> VideoUpscaler -> FrameWriter on "
              f"{FILES} 4K PNG frames, the .y4m branch, the entry points [{smi}]", flush=True)
        t27 = time.perf_counter()
        for fut in prep[2:]:
            fut.result()
        cfg4k = cfgs["fp32"]
        vu = lanczos_torch.VideoUpscaler(cfg4k, batch=1)
        outs = [path(f"up{k}.png") for k in range(FILES)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with FrameWriter(encode_workers=4) as w:
            for k, up in enumerate(vu.frames(im for _, im in FrameLoader(paths))):
                w.write(outs[k], up)
        t_pipe = time.perf_counter() - t0
        expect_launches("FrameLoader -> VideoUpscaler -> FrameWriter", read_counts(),
                        {"fused_resample_fp32": FILES})
        t0 = time.perf_counter()
        n = sum(1 for _ in FrameLoader(paths))
        t_load = time.perf_counter() - t0
        ups = [on_card(models["fp32"], f) for f in frames]
        for k in range(FILES):
            equal_bytes(f"frame {k} written vs Upscaler", read_png(outs[k]), ups[k])
        t0 = time.perf_counter()
        with FrameWriter(encode_workers=4) as w:
            for k, up in enumerate(ups):
                w.write(path(f"w{k}.png"), up)
        t_write = time.perf_counter() - t0
        print(f"  {FILES} frames: pipeline {t_pipe:.3f} s ({FILES / t_pipe:.3f} frames/s); the "
              f"loader's decode alone {t_load:.3f} s ({n / t_load:.2f} frames/s, 4 threads); the "
              f"writer's encode alone {t_write:.3f} s ({FILES / t_write:.3f} frames/s, 4 threads, "
              f"level 6)", flush=True)
        del ups

        t0 = time.perf_counter()
        outp, counts = cli_in_process([path("in.y4m"), path("cli.y4m")])
        t_y4m = time.perf_counter() - t0
        with open(path("cli.y4m"), "rb") as f, open(path("ref.y4m"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError("the CLI's .y4m branch differs from upscale_y4m")
        print(f"  {outp.strip()}: identical bytes to upscale_y4m; launches {counts}; "
              f"{8 / t_y4m:.2f} frames/s through the CLI", flush=True)

        model, args = entry()
        torch.cuda.synchronize()
        reset_counts()
        y = model(*args)
        torch.cuda.synchronize()
        expect_launches("entry()", read_counts(), {"fused_resample_fp32": 1})
        if tuple(y.shape) != (4320, 7680, 3) or y.dtype != torch.uint8 or bool(y.any()):
            raise AssertionError(f"entry(): {tuple(y.shape)} {y.dtype}, nonzero {bool(y.any())}")
        del model, args, y
        t0 = time.perf_counter()
        reset_counts()
        dryrun_multichip(8, ["cuda:0"] * 8)
        print(f"  dryrun_multichip(8) on Mesh.local([cuda:0] * 8): "
              f"{time.perf_counter() - t0:.1f} s, launches {read_counts()}", flush=True)
        print(f"  phase 27: {time.perf_counter() - t27:.1f} s", flush=True)

        torch.cuda.empty_cache()


def certification(smi: str) -> None:
    """Phase 28: the certification harness with ``hwcert.py``'s defaults,
    in this process (the bit-exact seeds are phase 11's)."""
    import contextlib
    import io

    from lanczos_torch.tools import hwcert

    argv = ["--seeds", "40", "--exact-seeds", "0", "--aniso-seeds", "6", "--u16-seeds", "6",
            "--y4m", "1", "--y4m-colorspaces", "420p10,422p12,mono"]
    print(f"== 28. certification: python -m lanczos_torch.tools.hwcert {' '.join(argv)} "
          f"[{smi}]", flush=True)
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = hwcert.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    rows, summary = lines[:-1], lines[-1]
    routes = {}
    for r in rows:
        key = r.get("route", r.get("kind"))
        routes[key] = routes.get(key, 0) + 1
    print(f"  rows by route or class: {routes}; launches: {counts}", flush=True)
    for r in rows:
        if not r["ok"]:
            print(f"  FAILED: {json.dumps(r)}", flush=True)
    print(f"  summary: {json.dumps(summary)}", flush=True)
    print(f"  certification took {wall:.1f} s", flush=True)
    if rc != 0 or summary["failed"] or summary["seeds"] != 55:
        raise AssertionError(f"certification: rc {rc}, {summary['failed']} of "
                             f"{summary['seeds']} rows failed (55 expected)")
    for family in ("fused_resample_", "shift_resample", "phase_"):
        if not any(k.startswith(family) for k in counts):
            raise AssertionError(f"certification: no {family}* kernel was launched")


def constant_planes(smi: str) -> None:
    """Phase 29: constant planes through the three kernel families
    (``lanczos_torch.tools.constant_planes``)."""
    import torch

    import lanczos_torch
    from lanczos_torch.tools import constant_planes as cp

    print(f"== 29. constant planes: each kernel family, identical bytes to its plain version "
          f"[{smi}]", flush=True)
    reset_counts()
    shares = cp.reference_137("cuda")
    torch.cuda.synchronize()
    print(f"  24x20 2/1 a=3 v=137 (tests/test_invariants.py), share of pixels not 137: "
          f"{shares}; launches {read_counts()}", flush=True)
    if any(shares.values()):
        raise AssertionError("a kernel family loses a level on the reference's constant plane")
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", FRAME, scale=(2, 1), a=3)
    t0 = time.perf_counter()
    # the CPU count (the plain passes over each plane's distinct rows) on a host thread
    with ThreadPoolExecutor(1) as thread:
        cpu = {f: thread.submit(cp.distinct_row_losses, cp.family_ops(cfg, f, "cpu"))
               for f in cp.FAMILIES}
        for family in cp.FAMILIES:
            ops = cp.family_ops(cfg, family, "cuda")
            torch.cuda.synchronize()
            reset_counts()
            t1 = time.perf_counter()
            lost = cp.plane_losses(ops, "cuda")
            counts = read_counts()
            host = cpu[family].result()
            print(f"  {family} 4K->8K, one plane of each of 0..255 ({time.perf_counter() - t1:.1f} "
                  f"s; launches {counts}): values with a pixel at v-1 {len(lost)} on the card, "
                  f"each plane identical bytes to the plain version on the card; {len(host)} "
                  f"from the plain passes on the CPU; {lost}", flush=True)
            if lost != host:
                raise AssertionError(f"{family}: the card's losses differ from the CPU's")
            if sum(counts.values()) < 256:
                raise AssertionError(f"{family}: the kernel ran {counts}, not 256 times")
    print(f"  constant planes took {time.perf_counter() - t0:.1f} s", flush=True)


FILTERS = ("mitchell", "catmull_rom", "triangle", "box")


def other_filters(img: np.ndarray, smi: str) -> None:
    """Phase 30: the non-Lanczos filters through the three kernel families
    at full width, against float64 gathers and their plain versions."""
    import torch

    import lanczos_torch
    from lanczos_torch.ops import resample_cuda as rc
    from lanczos_torch.utils.timing import cuda_time_ms

    print(f"== 30. mitchell, catmull_rom, triangle, box at a = 2 and 3 through the fused "
          f"kernel, kernel 2 and v1 at full width (3 planes; ms: CUDA events, mean of 20 after "
          f"3) [{smi}]", flush=True)
    rng = np.random.default_rng(30)
    frames = {"4K->8K": (img, dict(scale=(2, 1))),
              "8K->480x270": (rng.integers(0, 256, (4320, 7680, 3), dtype=np.uint8),
                              dict(out_shape=(270, 480))),
              "1440p->4K": (rng.integers(0, 256, (1440, 2560, 3), dtype=np.uint8),
                            dict(out_shape=(2160, 3840)))}
    paths = [  # name, frame, overrides, variant
        ("fused fp32", "4K->8K", {}, "mxu"),
        ("fused bf16", "4K->8K", dict(precision="bf16"), "mxu"),
        ("fused dering+quantize", "4K->8K", dict(dering=True, intermediate_quantize=True),
         "mxu"),
        ("kernel 2 dering", "4K->8K", dict(dering=True), "v2"),
        ("v1 stream", "8K->480x270", {}, "v1"),
        ("v1 window", "1440p->4K", {}, "v1"),
    ]

    def cfg_of(filt, a, frame, kw):
        im, shape_kw = frames[frame]
        return lanczos_torch.ResampleConfig.from_profile(
            "precise", im.shape[:2], a=a, filter=filt, **shape_kw, **kw)

    t0 = time.perf_counter()
    timed = []
    with ThreadPoolExecutor(8) as threads:
        refs = {}
        for filt in FILTERS:
            for a in (2, 3):
                for _, frame, kw, _ in paths:
                    key = (filt, a, frame, kw.get("dering", False),
                           kw.get("intermediate_quantize", False))
                    if key not in refs:  # fp32 and bf16 share one float64 reference
                        fkw = {k: v for k, v in kw.items() if k != "precision"}
                        refs[key] = threads.submit(gather_f64, frames[frame][0],
                                                   cfg_of(filt, a, frame, fkw))
        on_card = {k: torch.from_numpy(im).cuda() for k, (im, _) in frames.items()}
        planar = {k: v.permute(2, 0, 1).contiguous() for k, v in on_card.items()}
        for filt in FILTERS:
            for a in (2, 3):
                for name, frame, kw, variant in paths:
                    cfg = cfg_of(filt, a, frame, kw)
                    ops = rc.FusedOps(cfg, "cuda", variant=variant)
                    want_kernels = ops.phase.kernels if ops.phase is not None else (ops.kernel,)
                    if ops.variant != variant:
                        raise AssertionError(f"{filt} a={a} {name}: runs {ops.kernel}")
                    torch.cuda.synchronize()
                    reset_counts()
                    y = rc.resample_2d_cuda(on_card[frame], ops)
                    torch.cuda.synchronize()
                    n = read_counts()
                    if n != {k: 1 for k in want_kernels}:
                        raise AssertionError(f"{filt} a={a} {name}: launches {n}")
                    label = f"{filt} a={a} {name} {frame} ({', '.join(want_kernels)})"
                    compare(f"{label} vs plain version", y,
                            plain_version(planar[frame], ops).permute(1, 2, 0), "exact")
                    # the reference's own yardstick (hwcert.py): its fp32 gather, here the
                    # port's backend="xla" on the card, under the whole contract
                    lim = limits(cfg, ops.variant)
                    xla = lanczos_torch.Upscaler(cfg, backend="xla")(on_card[frame])
                    compare(f"{label} vs backend='xla'", y, xla, lim)
                    # the float64 gather under the LSB bound; where an exactly integral
                    # value is common (triangle a=3, mitchell) every fp32 path, the JAX
                    # package's included, differs from it on more than 1% (PERF.md)
                    key = (filt, a, frame, cfg.dering, cfg.intermediate_quantize)
                    compare(f"{label} vs float64 gather", y, refs[key].result(),
                            BOUND_ONLY[lim])
                    # mitchell and catmull_rom ignore a: their support is 2
                    support = 2 if filt in ("mitchell", "catmull_rom") else a
                    timed.append((label, frame, ops, kernel_bound(
                        cfg_of(filt, support, frame, kw), 3), support))
                    del xla, y
    print(f"  checks took {time.perf_counter() - t0:.1f} s (float64 gathers on 8 host "
          f"threads meanwhile)", flush=True)
    # timed once the host threads are done: a launch the host delays shows in the events
    for label, frame, ops, bnd, support in timed:
        ms = cuda_time_ms(rc.upscale_planar, planar[frame], ops)
        print(f"  {label}: {ms:.4f} ms/frame, bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']} (support {support}): {ms / bnd['bound_ms']:.1f}x", flush=True)
    torch.cuda.empty_cache()


PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


HEADLINE = "3840x2160->7680x4320_lanczos3_upscale"
SUITE_ARGS = ["--bf16", "--mesh", "4", "--devices", "8", "--frames", "16", "--iters", "10"]
SUITE_ROWS = [
    "256x256->512x512_a2", "1080p->4K_a3", "batch32_1080p->4K_a3",
    "batch32_1080p->4K_a3_planar", "4K->8K_a3", "4K->8K+1px_a3_largeN",
    "4K->8K_a3_dropnorm", "4K->8K_a3_dropdering", "4K->8K_a3_wf_quant",
    "7680x4320_a3_bf16", "stream7680x4320_a3_chunk1024", "7680x4320_a3_mesh2x4",
    "video16f_7680x4320_mesh2x4",
]


def bench_scripts(smi: str, kernels: list) -> None:
    """Phase 31: ``python -m lanczos_torch.tools.bench`` and ``bench_suite``
    as a user runs them, each a process of its own, one after the other;
    their JSON lines echoed, the launches of their rows' checked and timed
    calls (not the kernel alone beside them) as the fused kernels'
    ``bench_launches``, the headline beside phase 5's kernel time."""
    import torch

    print(f"== 31. the benchmark scripts as processes: python -m lanczos_torch.tools.bench; "
          f"python -m lanczos_torch.tools.bench_suite {' '.join(SUITE_ARGS)} [{smi}]",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows = {}
    for module, args in (("lanczos_torch.tools.bench", []),
                         ("lanczos_torch.tools.bench_suite", SUITE_ARGS)):
        t0 = time.perf_counter()
        out = finish(start(["-m", module] + args), module, timeout=400, echo=True)
        for line in out.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                row = json.loads(line)
                rows[row["metric"]] = row
        print(f"  {module}: {time.perf_counter() - t0:.1f} s", flush=True)
    missing = [m for m in [HEADLINE] + SUITE_ROWS if m not in rows]
    if missing:
        raise AssertionError(f"rows missing from the scripts' output: {missing}")
    unmeasured = [m for m, r in rows.items() if r["value"] is None]
    if unmeasured:
        raise AssertionError(f"rows with no value on the card: {unmeasured}")
    for m in SUITE_ROWS[-2:]:
        if rows[m]["virtual_mesh"] is not True or rows[m]["vs_baseline"] is not None:
            raise AssertionError(f"{m}: 8 positions on one card must be a virtual mesh")
    head = rows[HEADLINE]
    if not {"fused_resample_fp32", "fused_resample_bf16"} <= set(head["launches"]):
        raise AssertionError(f"bench launched {head['launches']}: not both fused tiers")
    by_name = {k["name"]: k for k in kernels}
    for tier, key in (("fp32", "band_ms"), ("bf16", "bf16_band_ms")):
        call = head[key][1]
        kernel = by_name[f"fused_resample_{tier}"]["ms"]
        print(f"  headline {tier}: {call:.4f} ms/frame, a batch-4 call {4 * call:.4f} ms; "
              f"phase 5's fused kernel {kernel:.4f} ms a 3-plane frame, x4 = "
              f"{4 * kernel:.4f} ms: call / kernel {call / kernel:.3f}", flush=True)
    launches = {}
    for r in rows.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"  launches of the rows' checked and timed calls: {launches}", flush=True)
    for k in kernels:
        if k["name"].startswith("fused_resample_"):
            k["bench_launches"] = launches.get(k["name"], 0)


def across_cards(img: np.ndarray, smi: str) -> None:
    """Phase 32: the sharded paths over every visible card, when there are
    two or more: ``tools/multicard.py`` in both forms (one process over
    ``Mesh.local`` of the cards on every mesh shape, and 2 and N NCCL ranks,
    and one), ``upscale(mesh=)``, ``upscale_y4m(mesh=)``,
    ``dryrun_multichip``, examples 03 and 06 and ``bench_suite``'s mesh and
    video rows, each byte-equal to one card.  Every step runs; the phase
    fails at its end if one failed.  On one card it prints that it did not
    run."""
    import torch

    import lanczos_torch
    from lanczos_torch.entry import dryrun_multichip
    from lanczos_torch.io import y4m
    from lanczos_torch.parallel.mesh import Mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"== 32. the sharded paths across cards: not run, {cards} card visible (the "
              "phase needs 2 or more; phases 18-23 ran every mesh on the one card)", flush=True)
        return
    t32 = time.perf_counter()
    devs = spread(cards, cards)
    print(f"== 32. the sharded paths across {cards} cards, {devs} [{smi}]", flush=True)
    torch.cuda.empty_cache()
    failed = []

    def step(name: str, fn) -> None:
        t0 = time.perf_counter()
        try:
            fn()
            print(f"  {name}: passed in {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception as e:  # the phase fails at its end; the next step still runs
            print(f"  {name}: FAILED: {type(e).__name__}: {e}", flush=True)
            failed.append(name)

    def echoed(args: list, name: str, timeout: float) -> str:
        out = finish(start(args), name, timeout)
        print(out, end="", flush=True)
        return out

    # multicard --local prints the peer access matrix; each form exits 1 on a difference
    forms = [["--local", "--ranks", str(cards)], ["--ranks", "2"], ["--ranks", str(cards)],
             ["--ranks", "1"]]
    for form in forms[:2] + forms[2 if cards > 2 else 3:]:
        name = "multicard " + " ".join(form)
        step(name, lambda: echoed(["-m", "lanczos_torch.tools.multicard", *form], name, 400))

    rows_mesh = Mesh.local(devs, (1, cards))
    x1 = torch.from_numpy(img[None]).cuda()

    def upscale_on_mesh() -> None:
        want = lanczos_torch.upscale(x1, scale=(2, 1))
        sync_cards()
        reset_counts()
        got = lanczos_torch.upscale(x1, scale=(2, 1), mesh=rows_mesh)
        sync_cards()
        n = read_counts()
        ms = wall_ms(lambda: lanczos_torch.upscale(x1, scale=(2, 1), mesh=rows_mesh), iters=3)
        print(f"  upscale(mesh=Mesh.local({devs}, (1, {cards}))): launches {n}, {ms:.4f} ms wall "
              "a 4K->8K frame (a new ShardedUpscaler a call, its plans built); "
              f"{'identical' if torch.equal(got, want) else 'DIFFERS'} to upscale() on one card",
              flush=True)
        if not torch.equal(got, want) or n != {"fused_resample_fp32": 2 * cards}:
            raise AssertionError(f"upscale(mesh=): launches {n} or bytes differ")

    def y4m_on_mesh() -> None:
        rng = np.random.default_rng(32)
        ch, cw = FRAME[0] // 2, FRAME[1] // 2
        with tempfile.TemporaryDirectory() as tmp:
            src = f"{tmp}/in.y4m"
            with y4m.Y4MWriter(src, y4m.Y4MHeader(FRAME[1], FRAME[0], fps=(24, 1),
                                                   colorspace="420jpeg")) as writer:
                for _ in range(8):
                    writer.write(tuple(rng.integers(0, 256, s, dtype=np.uint8)
                                       for s in (FRAME, (ch, cw), (ch, cw))))
            t0 = time.perf_counter()
            lanczos_torch.upscale_y4m(src, f"{tmp}/one.y4m", scale=(2, 1))
            t1 = time.perf_counter()
            lanczos_torch.upscale_y4m(src, f"{tmp}/mesh.y4m", scale=(2, 1), mesh=rows_mesh)
            t2 = time.perf_counter()
            with open(f"{tmp}/one.y4m", "rb") as f, open(f"{tmp}/mesh.y4m", "rb") as g:
                same = f.read() == g.read()
        print(f"  upscale_y4m(mesh=(1, {cards})): 8 frames 4:2:0 4K->8K, {t2 - t1:.2f} s wall "
              f"(one card {t1 - t0:.2f} s); the file {'identical' if same else 'DIFFERS'}",
              flush=True)
        if not same:
            raise AssertionError("upscale_y4m(mesh=) wrote other bytes than one card")

    def dryrun() -> None:
        reset_counts()
        dryrun_multichip(cards, devs)
        print(f"  dryrun_multichip({cards}, {devs}): launches {read_counts()}", flush=True)

    step("upscale(mesh=)", upscale_on_mesh)
    step("upscale_y4m(mesh=)", y4m_on_mesh)
    step("entry.dryrun_multichip", dryrun)
    torch.cuda.empty_cache()
    for example in ("03_sharded_mesh.py", "06_sharded_video_stream.py"):
        name = f"examples_torch/{example} --n {cards}"
        step(name, lambda: echoed([f"examples_torch/{example}", "--n", str(cards)], name, 300))
    suite = ["--mesh", str(cards), "--devices", str(cards), "--frames", "16"]

    def suite_rows() -> None:
        name = "bench_suite " + " ".join(suite)
        out = echoed(["-m", "lanczos_torch.tools.bench_suite", *suite], name, 600)
        rows = [json.loads(v) for v in out.splitlines() if v.startswith("{")]
        mesh_rows = [r for r in rows if "mesh" in r["metric"]]
        if not (len(mesh_rows) == 2 and all(
                r["virtual_mesh"] is False and r["value"] is not None for r in mesh_rows) and (
                mesh_rows[0]["measured_eff"] is not None and mesh_rows[0]["ici_bw"] is not None)):
            raise AssertionError("its mesh and video rows are virtual or unmeasured")
        print(f"  {name}: mesh and video rows on real cards, measured", flush=True)

    step("bench_suite mesh rows", suite_rows)
    print(f"  phase 32: {time.perf_counter() - t32:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 32: {failed} failed")


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
                    got, want, "exact")
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
            compare(f"{ops.kernel} {name}", got, want, "exact")
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
                             y, plain.permute(1, 2, 0), "exact")
        del plain
    refs64 = {"linear": ref64}  # phase 15 holds the streamed frames to them too
    del outs, ref64
    torch.cuda.empty_cache()

    # ---- 5. times
    print("== 5. times at 4K->8K (3 planes, CUDA events, mean of 20 after 3 warm-up; "
          "order plain, kernel, kernel, plain)", flush=True)
    kernels = []
    frame = kernel_bound(cfgs["fp32"], 3)  # the same bytes and taps for every 4K->8K config
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
        err, _ = compare(f"{name} ({ops.kernel}) vs plain version", y, want, "exact")
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
        bnd = kernel_bound(ops.cfg, 3)
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
            kb = bound_of(nbytes, flops)
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

    upscaler_ms = bit_exact_and_float_paths(img, x, smi)
    streaming_and_video(img, x, smi, refs64, kernels)
    sharding(img, x, smi, kernels)
    cli_and_files(img, x, smi, upscaler_ms["fused kernel fp32 (auto) 4K->8K"])
    certification(smi)
    constant_planes(smi)
    other_filters(img, smi)
    bench_scripts(smi, kernels)
    across_cards(img, smi)

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
