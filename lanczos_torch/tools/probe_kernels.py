"""Where the time of the two redesigned kernels goes, on the H100.

    python -m lanczos_torch.tools.probe_kernels [fused] [shift] [sweep]

Each probe is the production source (``csrc/fused_resample.cu`` or
``csrc/shift_resample.cu``) with one piece of text substituted, built by
``nvcc`` into a library of its own and timed at 4K→8K (3 planes of
2160×3840 → 4320×7680, Lanczos-3, uniform noise from
``numpy.random.default_rng(0)``) beside the production kernel, through the
same launch arguments.  A probe's output is wrong by design; only its time
and its registers are read.

``fused`` (linear fp32, and fp32 dering):

- the timeline: ``empty`` returns at once (what launching the grid costs),
  ``loads`` returns after the tables and the band have arrived, ``vertical``
  after the vertical pass, ``nostore`` skips only the copy of the staged
  tile to the output;
- the products: ``novert``, ``nohoriz`` and ``noboth`` run zero window
  steps (epilogues, barriers, loads and stores stay);
- occupancy and unrolling: ``blocks3`` lets the compiler take 80 registers
  (three blocks an SM), ``unroll_h2`` unrolls the horizontal step loop by 2
  (which spills), ``unroll_v1`` leaves the vertical one rolled.

``shift`` (kernel 2, dering): ``empty``, ``loads``, ``novert``,
``nohoriz``, and ``threads256`` (blocks of 256 threads, three an SM).

``sweep``: the production fused kernel on plans of other row tiles and
column blocks (``plan_at``).

Times are CUDA events around 50 direct calls of the library function after
5 warm-up calls (the Python wrapper is not in the loop), ms per 3-plane
frame, printed with the card's name and power limit and ``nvcc -Xptxas -v``'s
registers and spills of every probe.
"""

from __future__ import annotations

import ctypes
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
from lanczos_torch.ops import resample_shift_cuda as rs
from lanczos_torch.tools.ablate_fused import FRAME_IN, card

_NO_STEPS_V = ("for (int s = 0; s < g.win_v; ++s)", "for (int s = 0; s < 0; ++s)")
_NO_STEPS_H = ("for (int s = 0; s < g.win_h; ++s)", "for (int s = 0; s < 0; ++s)")
_ENTRY_F = "  extern __shared__ uint4 smem16[];\n  const int tile_p = g.tile_p, bw = g.bw;"
_ENTRY_S = "  extern __shared__ uint4 smem16[];\n  const int s = S > 0 ? S : g.s"
_RETURN = "  if (g.H > 0) return;\n"

# name -> [(text in the production source, its replacement), ...]
FUSED_PROBES = {
    "empty": [(_ENTRY_F, _RETURN + _ENTRY_F)],
    "loads": [("  __syncthreads();\n\n  float acc[8][4];",
               "  __syncthreads();\n" + _RETURN + "  float acc[8][4];")],
    "vertical": [("  // 3. horizontal: thread tile", _RETURN + "  // 3. horizontal: thread tile")],
    "nostore": [("const int rows = min(g.tile, g.OH - i * g.tile), cols",
                 "const int rows = 0, cols")],
    "novert": [_NO_STEPS_V],
    "nohoriz": [_NO_STEPS_H],
    "noboth": [_NO_STEPS_V, _NO_STEPS_H],
    "blocks3": [("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)")],
    "unroll_h2": [("#pragma unroll 1\n      " + _NO_STEPS_H[0],
                   "#pragma unroll 2\n      " + _NO_STEPS_H[0])],
    "unroll_v1": [("#pragma unroll 2\n    " + _NO_STEPS_V[0],
                   "#pragma unroll 1\n    " + _NO_STEPS_V[0])],
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
SWEEP = ((64, 128), (64, 256), (128, 128), (96, 128), (32, 256), (32, 128), (128, 256))
SOURCES = {"lanczos_fused_resample": "fused_resample.cu",
           "lanczos_shift_resample": "shift_resample.cu"}


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


def main(argv=None) -> int:
    what = set(sys.argv[1:] if argv is None else argv) or {"fused", "shift", "sweep"}
    if what - {"fused", "shift", "sweep"}:
        print("probe_kernels: choose from fused, shift, sweep", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    lib = _build.library()
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (3,) + FRAME_IN, np.uint8)).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        if "fused" in what:
            fn = "lanczos_fused_resample"
            runs = {name: rc.FusedOps(frame_cfg(**kw), "cuda")
                    for name, kw in (("fp32", {}), ("fp32 dering", {"dering": True}))}
            args = {name: launch_args(fn, lambda ops=ops: rc.fused_call(ops, x))
                    for name, ops in runs.items()}
            for name, (a, _) in args.items():
                print(f"fused {name}: production {time_ms(getattr(lib, fn), a):.4f} ms "
                      f"[{smi}]", flush=True)
            for probe, subs in FUSED_PROBES.items():
                f, info = build_probe(fn, subs, Path(tmp), f"fused_{probe}")
                times = ", ".join(f"{name} {time_ms(f, a):.4f}" for name, (a, _) in args.items())
                print(f"fused probe {probe}: {times} ms ({info})", flush=True)
        if "sweep" in what:
            fn = "lanczos_fused_resample"
            for tile, cb in SWEEP:
                plan = rc.plan_at(frame_cfg(), tile, cb)
                if plan is None:
                    print(f"fused sweep tile {tile} cb {cb}: no plan", flush=True)
                    continue
                ops = rc.FusedOps(frame_cfg(), "cuda", plan)
                a, _out = launch_args(fn, lambda ops=ops: rc.fused_call(ops, x))
                print(f"fused sweep tile {tile} cb {cb}: {time_ms(getattr(lib, fn), a):.4f} ms, "
                      f"{plan.smem_bytes()} B of shared memory [{smi}]", flush=True)
        if "shift" in what:
            fn = "lanczos_shift_resample"
            ops = rc.FusedOps(frame_cfg(dering=True), "cuda", variant="v2")
            a, _out = launch_args(fn, lambda: rs.shift_call(ops.shift, x))
            print(f"shift dering: production {time_ms(getattr(lib, fn), a):.4f} ms [{smi}]",
                  flush=True)
            for probe, subs in SHIFT_PROBES.items():
                f, info = build_probe(fn, subs, Path(tmp), f"shift_{probe}")
                print(f"shift probe {probe}: dering {time_ms(f, a):.4f} ms ({info})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
