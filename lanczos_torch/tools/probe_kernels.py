"""Where the time of the redesigned kernels goes, on the H100.

    python -m lanczos_torch.tools.probe_kernels [fused] [shift] [sweep] [phase] [interleaved]

(``stream`` and ``window`` are the two halves of ``phase``.)

Each probe is the production source (``csrc/fused_resample.cu``,
``csrc/shift_resample.cu`` or ``csrc/phase_resample.cu``) with one piece of
text substituted, built by ``nvcc`` into a library of its own and timed
beside the production kernel, through the same launch arguments: the fused
kernel and kernel 2 at 4K→8K (3 planes of 2160×3840 → 4320×7680), v1 at
its three full-width shapes (Lanczos-3, uniform noise from
``numpy.random.default_rng(0)``).  A probe's output is wrong by design;
only its time and its registers are read.

``fused`` (4K→8K linear fp32 and fp32 dering, 1440p→4K linear fp32: the
2/1 and 3/2 plans of the benchmark's cells), probes of the pipelined kernel:

- the timeline: ``empty`` returns at once (what launching the persistent
  grid costs), ``loads`` runs the producer alone (its consumers wait for each
  stage and hand it back, with no passes and no stores), ``nostore`` skips
  only the TMA stores of the staged tiles;
- the products: ``novert``, ``nohoriz`` and ``noboth`` run zero window
  steps (epilogues, barriers, loads and stores stay);
- the ring: ``ring1`` and ``ring2`` hold one and two stages (one stage:
  a tile's loads wait for the previous tile's passes), ``blocks1`` and
  ``blocks2`` run one and two blocks an SM (consumers at 232 and 96
  registers), ``staged3`` stages three output tiles a block (two stages),
  ``tile`` forces the one-tile-a-block kernel on the same launch;
  ``unroll_h2`` and ``unroll_v4`` unroll the step loops further.

``interleaved``: the ring on a batch of four RGB and of four RGBA frames
(``quality4k-batch4-upscale``'s batch at 3/2, and 4K→8K at 2/1): the planar
ring on their planes, then the ring's interleaved form on the four (B, H, W,
C) frames as they lie, at each block width tried (``INTERLEAVED_BLOCKS``;
the production one is ``resample_cuda.interleaved_block``), each line with
the ring's stages and blocks an SM and whether its bytes equal the planar
ring's.

``shift`` (kernel 2, dering): ``empty``, ``loads``, ``novert``,
``nohoriz``, and ``threads256`` (blocks of 256 threads, three an SM).

``sweep``: the production fused kernel on plans of other row tiles and
column blocks (``plan_at``), at 2/1 and at 3/2, each line with the ring's
stages and blocks an SM (0 and 0: the one-tile-a-block kernel).

``phase`` (v1, fp32 and bf16): at 8K→480×270 the streamed design's two
kernels: ``empty``, ``loads`` (the copies and the walk without the
arithmetic; for the second kernel the staged band without the tap chains),
rings of 2 and 4 stages, stages of 16 and 64 rows, the row loop unrolled by
2 and 8 and blocks of 2 and 4 warps for the first, 16 band loads in flight a
thread instead of 4 and blocks of 8 and 32 columns (run-time arguments)
for the second, and the first kernel at other chunks of output rows (a
run-time argument); at
1440p→4K and 2160×2880→4K the window design: ``empty``, ``loads``,
``novert``, ``nohoriz``, ``blocks5`` / ``blocks6`` (102 / 85 registers), and
its run-time form on the same plan; and at all three the generic design
forced, which at the thumbnail is also the one-kernel alternative to the
streamed design's two (a tile a block, band and intermediate in shared
memory).

Times are CUDA events around 50 direct calls of the library function after
5 warm-up calls (the Python wrapper is not in the loop), ms per 3-plane
frame, printed with the card's name and power limit and ``nvcc -Xptxas -v``'s
registers and spills of every probe.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

from lanczos_torch.core.config import ResampleConfig
from lanczos_torch.ops import _build
from lanczos_torch.ops import resample_cuda as rc
from lanczos_torch.ops import resample_phase_cuda as rp
from lanczos_torch.ops import resample_shift_cuda as rs
from lanczos_torch.tools.ablate_fused import FRAME_IN, card

_NO_STEPS_V = ("for (int s = 0; s < g.win_v; ++s)", "for (int s = 0; s < 0; ++s)")
_NO_STEPS_H = ("for (int s = 0; s < g.win_h; ++s)", "for (int s = 0; s < 0; ++s)")
_ENTRY_F = "  extern __shared__ uint8_t ring_smem[];"
_ENTRY_S = "  extern __shared__ uint4 smem16[];\n  const int s = S > 0 ? S : g.s"
_RETURN = "  if (g.H > 0) return;\n"
_NEVER = "if (g.H < 0) "  # false at run time: the code stays, its work does not run
_VERT = "      vertical_pass<BF16, DERING, QUANT>(tid, st,"
_HORIZ = "        horizontal_pass<DERING, false>(tid, midT,"  # the planar ring's
_STORE = "        for (int q = 0; q < 4; ++q)\n          tma_store_3d("
_NO_STORE = (_STORE, "        for (int q = 0; q < 4 * (g.H < 0); ++q)\n          tma_store_3d(")
_RING = "const Ring R = ring_layout(g, dering != 0, stages);"

# name -> [(text in the production source, its replacement), ...]
FUSED_PROBES = {
    "empty": [(_ENTRY_F, _RETURN + _ENTRY_F)],
    "loads": [(_VERT, _VERT.replace("vertical", _NEVER + "vertical")),
              (_HORIZ, _HORIZ.replace("horizontal", _NEVER + "horizontal")), _NO_STORE],
    "nostore": [_NO_STORE],
    "novert": [_NO_STEPS_V],
    "nohoriz": [_NO_STEPS_H],
    "noboth": [_NO_STEPS_V, _NO_STEPS_H],
    "ring1": [(_RING, _RING.replace("stages);", "1);"))],
    "ring2": [(_RING, _RING.replace("stages);", "2);"))],
    "blocks1": [("__launch_bounds__(kRingThreads, kRingBlocks)", "__launch_bounds__(kRingThreads, 1)"),
                ("setmaxnreg.inc.sync.aligned.u32 72;", "setmaxnreg.inc.sync.aligned.u32 232;"),
                ("min(R.total, blocks * multiprocessors())", "min(R.total, multiprocessors())")],
    "blocks2": [("__launch_bounds__(kRingThreads, kRingBlocks)", "__launch_bounds__(kRingThreads, 2)"),
                ("setmaxnreg.inc.sync.aligned.u32 72;", "setmaxnreg.inc.sync.aligned.u32 96;"),
                ("min(R.total, blocks * multiprocessors())", "min(R.total, 2 * multiprocessors())")],
    "staged3": [("constexpr int kStaged = 2;", "constexpr int kStaged = 3;"),
                (_RING, _RING.replace("stages);", "2);"))],
    "tile": [("  if (stages > 0) {", "  if (stages < 0) {")],
    "unroll_h2": [("#pragma unroll 1\n    " + _NO_STEPS_H[0], "#pragma unroll 2\n    " + _NO_STEPS_H[0])],
    "unroll_v4": [("#pragma unroll 2\n    " + _NO_STEPS_V[0], "#pragma unroll 4\n    " + _NO_STEPS_V[0])],
}
SHIFT_PROBES = {
    "empty": [(_ENTRY_S, _RETURN + _ENTRY_S)],
    "loads": [("  cp_async_wait_all();\n  __syncthreads();\n",
               "  cp_async_wait_all();\n  __syncthreads();\n" + _RETURN)],
    "novert": [("for (int p = 0; p < nv; ++p) {\n          float w[kTaps], o[4][kRun];",
                "for (int p = 0; p < 0; ++p) {\n          float w[kTaps], o[4][kRun];")],
    "nohoriz": [("for (int p = 0; p < nh; ++p) {\n          float w[kTaps], o[2][kRun];",
                 "for (int p = 0; p < 0; ++p) {\n          float w[kTaps], o[2][kRun];")],
    "threads256": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
                   ("__launch_bounds__(kThreads, 6)", "__launch_bounds__(kThreads, 3)")],
}
_ENTRY_W = ("  extern __shared__ uint4 smem16[];\n"
            "  const int taps_v = 2 * g.sv, taps_h = 2 * g.sh;")
_ENTRY_SV = "  constexpr int LW = (LIVE + 3) / 4 * 4;\n  extern __shared__ uint4 smem16[];"
_ENTRY_SH = ("  extern __shared__ float4 smem4[];\n"
             "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
             "  const int es = g.eh | 1;")
_BOUNDS_W = "__launch_bounds__(kWinThreads, 4)"
# library function -> name -> [(text in csrc/phase_resample.cu, its replacement), ...]
PHASE_PROBES = {
    "lanczos_phase_window": {
        "empty": [(_ENTRY_W, _RETURN + _ENTRY_W)],
        "loads": [("  cp_async_wait_all();\n  __syncthreads();\n\n  if constexpr (VA::N > 0) {",
                   "  cp_async_wait_all();\n  __syncthreads();\n" + _RETURN
                   + "  if constexpr (VA::N > 0) {")],
        "novert": [("it < (g.pv / K) * ng; it += kWinThreads", "it < 0; it += kWinThreads")],
        "nohoriz": [("it < (tr >> 1) * ng; it += kWinThreads", "it < 0; it += kWinThreads")],
        "blocks5": [(_BOUNDS_W, "__launch_bounds__(kWinThreads, 5)")],
        "blocks6": [(_BOUNDS_W, "__launch_bounds__(kWinThreads, 6)")],
    },
    "lanczos_phase_stream_v": {
        "empty": [(_ENTRY_SV, _RETURN + _ENTRY_SV)],
        "loads": [("    const int nr = min(kStageRows, nrows - s * kStageRows);",
                   "    const int nr = 0;")],
        "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
        "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
        "rows16": [("constexpr int kStageRows = 32;", "constexpr int kStageRows = 16;")],
        "rows64": [("constexpr int kStageRows = 32;", "constexpr int kStageRows = 64;")],
        "unroll2": [("#pragma unroll 4\n    for (int row = 0; row < nr; ++row) {",
                     "#pragma unroll 2\n    for (int row = 0; row < nr; ++row) {")],
        "unroll8": [("#pragma unroll 4\n    for (int row = 0; row < nr; ++row) {",
                     "#pragma unroll 8\n    for (int row = 0; row < nr; ++row) {")],
        "warps2": [("constexpr int kStreamWarps = 1;", "constexpr int kStreamWarps = 2;")],
        "warps4": [("constexpr int kStreamWarps = 1;", "constexpr int kStreamWarps = 4;")],
    },
    "lanczos_phase_stream_h": {
        "empty": [(_ENTRY_SH, "  if (g.OH > 0) return;\n" + _ENTRY_SH)],
        "loads": [("  __syncthreads();\n  if (lane < rows_n) {",
                   "  __syncthreads();\n  if (g.OH > 0) return;\n  if (lane < rows_n) {")],
        "batch16": [("constexpr int kHBatch = 4; ", "constexpr int kHBatch = 16;")],
    },
}
STREAM_CHUNKS = (14, 18, 23, 27, 30, 34, 39, 45, 68, 135, 270)  # output rows a chunk of the streamed pass
# v1's full-width shapes: name, input, output
PHASE_SHAPES = (("8K->480x270", (4320, 7680), (270, 480)),
                ("1440p->4K", (1440, 2560), (2160, 3840)),
                ("2160x2880->4K", (2160, 2880), (2160, 3840)))
SWEEP = ((64, 128), (64, 256), (128, 128), (96, 128), (32, 256), (32, 128), (128, 256))
SWEEP_32 = ((64, 96), (64, 48), (128, 96), (32, 96), (64, 144), (64, 192))  # 3/2: multiples of 48
QUALITY_IN = (1440, 2560)  # FSR Quality, 1440p -> 4K
# channels -> block widths: staged rows of 96, 144, 192 and 240 bytes (RGB), 128, 192, 256 (RGBA)
INTERLEAVED_BLOCKS = {3: (32, 48, 64, 80), 4: (32, 48, 64)}
SOURCES = {"lanczos_fused_resample": "fused_resample.cu",
           "lanczos_shift_resample": "shift_resample.cu",
           **{fn: "phase_resample.cu" for fn in (
               "lanczos_phase_resample", "lanczos_phase_window",
               "lanczos_phase_stream_v", "lanczos_phase_stream_h")}}


def probe_source(function: str, subs: list) -> str:
    """The production source of ``function`` with every substitution made;
    raises where a probe's text is no longer in the source."""
    src = (_build.CSRC / SOURCES[function]).read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{SOURCES[function]}: expected once: {old!r}")
        src = src.replace(old, new)
    return src


def build_probe(function: str, subs: list, workdir: Path, name: str):
    """Compile a probe; returns its library function and what ``ptxas``
    said of registers and spills."""
    cu = workdir / f"{name}.cu"
    cu.write_text(probe_source(function, subs))
    so = workdir / f"{name}.so"
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
         "-shared", "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on probe {name}:\n{res.stdout}{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in lines if "Used " in ln})
    spills = sorted({ln.strip() for ln in lines
                     if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln})
    fn = getattr(ctypes.CDLL(str(so)), function)
    fn.argtypes = getattr(_build.library(), function).argtypes
    fn.restype = ctypes.c_int
    return fn, f"{', '.join(regs)}; spills: {spills or 'none'}"


def launch_args(function: str, call) -> tuple:
    """The arguments ``call()`` passes to the library's ``function``, with
    ``call``'s result, whose memory they point to and which the caller
    keeps for as long as it launches with them."""
    lib, seen = _build.library(), {}

    def spy(*args):
        seen["args"] = args
        return getattr(lib, function)(*args)

    shim = types.SimpleNamespace(
        **{function: spy, "lanczos_cuda_error_string": lib.lanczos_cuda_error_string})
    real = _build.library
    _build.library = lambda: shim
    try:
        out = call()
    finally:
        _build.library = real
    torch.cuda.synchronize()
    return seen["args"], out


def time_ms(fn, args: tuple, iters: int = 50) -> float:
    """Device ms per direct call of ``fn(*args)``."""
    for _ in range(5):
        _build.check(fn(*args))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def frame_cfg(**kw) -> ResampleConfig:
    return ResampleConfig.from_profile("precise", FRAME_IN, scale=(2, 1), a=3, **kw)


def quality_cfg(**kw) -> ResampleConfig:
    return ResampleConfig.from_profile("precise", QUALITY_IN, scale=(3, 2), a=3, **kw)


def ring_of(args: tuple) -> str:
    """The ring's stages and blocks an SM in a fused launch's arguments
    (the two integers before the stream)."""
    return f"ring {args[-3]} stages x {args[-2]} blocks an SM"


def probe_phase(lib, tmp: Path, smi: str, designs=("stream", "window")) -> None:
    """The ``phase`` group: v1's designs at their full-width shapes (only
    the shapes that ``designs`` take)."""
    built = {}  # (function, probe) -> (library function, ptxas summary)

    def probe(function, name):
        if (function, name) not in built:
            built[function, name] = build_probe(
                function, PHASE_PROBES[function][name], tmp, f"{function}_{name}")
        return built[function, name]

    for shape_name, shp, out in PHASE_SHAPES:
        x = torch.from_numpy(
            np.random.default_rng(0).integers(0, 256, (3,) + shp, np.uint8)).cuda()
        for precision in ("fp32", "bf16"):
            cfg = ResampleConfig.from_profile("precise", shp, out_shape=out, a=3,
                                              precision=precision)
            tag = f"phase {shape_name} {precision}"
            ops = rp.PhaseOps(cfg, "cuda")
            if ops.design not in designs:
                continue
            gen = rp.PhaseOps(cfg, "cuda", design="generic")
            a, _out = launch_args("lanczos_phase_resample", lambda: rp.phase_call(gen, x))
            note = " (the one-kernel alternative)" if shape_name.startswith("8K") else ""
            print(f"{tag}: generic design forced{note} "
                  f"{time_ms(lib.lanczos_phase_resample, a):.4f} ms, layout {gen.layout} "
                  f"[{smi}]", flush=True)
            if ops.design == "stream":
                fv, fh = "lanczos_phase_stream_v", "lanczos_phase_stream_h"
                av, mid = launch_args(fv, lambda: rp.stream_v_call(ops, x))
                ah, _out = launch_args(fh, lambda: rp.stream_h_call(ops, mid))
                tv, th = time_ms(getattr(lib, fv), av), time_ms(getattr(lib, fh), ah)
                print(f"{tag}: production stream_v {tv:.4f} + stream_h {th:.4f} = "
                      f"{tv + th:.4f} ms ({av[11]} rows a chunk, layout {ops.layout}) [{smi}]",
                      flush=True)
                for fn, args in ((fv, av), (fh, ah)):
                    for name in PHASE_PROBES[fn]:
                        f, info = probe(fn, name)
                        print(f"{tag}: {fn.removeprefix('lanczos_phase_')} probe {name} "
                              f"{time_ms(f, args):.4f} ms ({info})", flush=True)
                base_h, _ = ops.plan.h.taps(out[1])
                for tc in (8, 32):  # args[11] and [12]: the tile's columns and its band's
                    eh = rp._extent(base_h, tc, 2 * ops.plan.h.support)
                    t = time_ms(getattr(lib, fh), ah[:11] + (tc, eh) + ah[13:])
                    print(f"{tag}: stream_h at {tc} columns a block ({eh} read, "
                          f"{rp.stream_h_smem_bytes(ops.plan, tc, eh)} B) {t:.4f} ms", flush=True)
                for rpc in STREAM_CHUNKS:  # args[11] is the rows of a chunk
                    t = time_ms(getattr(lib, fv), av[:11] + (rpc,) + av[12:])
                    print(f"{tag}: stream_v at {rpc} rows a chunk {t:.4f} ms", flush=True)
            elif ops.design == "window":
                fn = "lanczos_phase_window"
                a, _out = launch_args(fn, lambda: rp.phase_call(ops, x))
                print(f"{tag}: production window {time_ms(getattr(lib, fn), a):.4f} ms "
                      f"(layout {ops.layout}) [{smi}]", flush=True)
                for name in PHASE_PROBES[fn]:
                    f, info = probe(fn, name)
                    print(f"{tag}: window probe {name} {time_ms(f, a):.4f} ms ({info})",
                          flush=True)
                # the run-time form on the same blocks: args[25] is the compile-time flag
                t = time_ms(getattr(lib, fn), a[:25] + (0,) + a[26:])
                print(f"{tag}: window run-time form {t:.4f} ms", flush=True)


def probe_interleaved(lib, smi: str) -> None:
    """The ``interleaved`` group: ms a frame of the planar ring and of the
    interleaved ring at each block width, on batches of four frames."""
    fn = "lanczos_fused_resample"
    for (name, make, shape), c in itertools.product(
            (("3/2", quality_cfg, QUALITY_IN), ("2/1", frame_cfg, FRAME_IN)), INTERLEAVED_BLOCKS):
        cfg = make()
        frames = torch.from_numpy(
            np.random.default_rng(0).integers(0, 256, (4,) + shape + (c,), np.uint8)).cuda()
        planes = frames.permute(0, 3, 1, 2).reshape(4 * c, *shape).contiguous()
        ops = rc.FusedOps(cfg, "cuda")
        a, want = launch_args(fn, lambda: rc.fused_call(ops, planes))
        want = want.reshape(4, c, *cfg.out_shape).permute(0, 2, 3, 1)
        print(f"interleaved {name} C={c}: planar ring {time_ms(getattr(lib, fn), a) / 4:.4f} ms "
              f"a frame (block {ops.plan.cb}), {ring_of(a)} [{smi}]", flush=True)
        for cb in INTERLEAVED_BLOCKS[c]:
            plan = rc.interleaved_plan(cfg, ops.plan.tile_out, c, cb)
            layout = plan and rc.upload_layout(plan, cfg, ops.device, c)
            tag = f"interleaved {name} C={c} block {cb}" + (
                " (production)" if cb == rc.interleaved_block(c) else "")
            if layout is None:
                print(f"{tag}: not on the ring", flush=True)
                continue
            ops_i = rc.FusedOps(cfg, "cuda")
            ops_i.layouts[c] = layout  # this block width in place of the production one
            a, got = launch_args(fn, lambda o=ops_i: rc.upscale_frames(frames, o))
            print(f"{tag}: {time_ms(getattr(lib, fn), a) / 4:.4f} ms a frame, {ring_of(a)}, "
                  f"bytes {'equal' if torch.equal(got, want) else 'DIFFER'}", flush=True)


GROUPS = ("fused", "shift", "sweep", "phase", "interleaved", "stream", "window")


def main(argv=None) -> int:
    what = set(sys.argv[1:] if argv is None else argv) or set(GROUPS[:4])
    if what - set(GROUPS):
        print(f"probe_kernels: choose from {', '.join(GROUPS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    lib = _build.library()
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (3,) + FRAME_IN, np.uint8)).cuda()
    xq = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (3,) + QUALITY_IN, np.uint8)).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        if "fused" in what:
            fn = "lanczos_fused_resample"
            runs = {"fp32": (frame_cfg(), x), "fp32 dering": (frame_cfg(dering=True), x),
                    "3/2 fp32": (quality_cfg(), xq)}
            ops = {name: rc.FusedOps(c, "cuda") for name, (c, _) in runs.items()}  # kept: the
            # launch arguments point into their tables
            args = {name: launch_args(fn, lambda o=ops[name], img=img: rc.fused_call(o, img))
                    for name, (_, img) in runs.items()}
            for name, (a, _) in args.items():
                print(f"fused {name}: production {time_ms(getattr(lib, fn), a):.4f} ms, "
                      f"{ring_of(a)} [{smi}]", flush=True)
            for probe, subs in FUSED_PROBES.items():
                f, info = build_probe(fn, subs, Path(tmp), f"fused_{probe}")
                times = ", ".join(f"{name} {time_ms(f, a):.4f}" for name, (a, _) in args.items())
                print(f"fused probe {probe}: {times} ms ({info})", flush=True)
        if "sweep" in what:
            fn = "lanczos_fused_resample"
            for name, make, img, sweep in (("2/1", frame_cfg, x, SWEEP),
                                           ("3/2", quality_cfg, xq, SWEEP_32)):
                for tile, cb in sweep:
                    plan = rc.plan_at(make(), tile, cb)
                    if plan is None:
                        print(f"fused sweep {name} tile {tile} cb {cb}: no plan", flush=True)
                        continue
                    ops = rc.FusedOps(make(), "cuda", plan)
                    a, _out = launch_args(fn, lambda ops=ops, img=img: rc.fused_call(ops, img))
                    print(f"fused sweep {name} tile {tile} cb {cb} (block {plan.cb}): "
                          f"{time_ms(getattr(lib, fn), a):.4f} ms, {ring_of(a)}, "
                          f"{plan.smem_bytes()} B of shared memory one tile a block [{smi}]",
                          flush=True)
        if "shift" in what:
            fn = "lanczos_shift_resample"
            ops = rc.FusedOps(frame_cfg(dering=True), "cuda", variant="v2")
            a, _out = launch_args(fn, lambda: rs.shift_call(ops.shift, x))
            print(f"shift dering: production {time_ms(getattr(lib, fn), a):.4f} ms [{smi}]",
                  flush=True)
            for probe, subs in SHIFT_PROBES.items():
                f, info = build_probe(fn, subs, Path(tmp), f"shift_{probe}")
                print(f"shift probe {probe}: dering {time_ms(f, a):.4f} ms ({info})", flush=True)
        if "interleaved" in what:
            probe_interleaved(lib, smi)
        designs = {"stream", "window"} & what if "phase" not in what else ("stream", "window")
        if designs:
            probe_phase(lib, Path(tmp), smi, tuple(designs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
