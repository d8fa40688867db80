"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``lanczos_torch/csrc/*.cu``, all in parallel, and
links them into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds), under ``lanczos_torch/_build/``,
named by a hash of the sources and flags;
``ctypes`` loads it.  Nothing is prebuilt or downloaded.  Without ``nvcc``
the build raises: there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# Shared memory one block may use on the target (sm_90a: an H100)
SMEM_LIMIT = 227 * 1024


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of lanczos_torch are built from source at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblanczos_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list) -> None:
    """Wait for every (cmd, Popen); raise with the first failure's output."""
    failed = None
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}{stderr}"
    if failed:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = [s for s in _sources() if s.suffix == ".cu"]
    # build in a private directory and rename the library into place: a
    # concurrent build never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in units]
        procs = []
        for src, obj in zip(units, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        _run(procs)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))])
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lanczos_fused_resample.argtypes = [ptr] * 11 + [i32] * 24 + [ptr]
    lib.lanczos_fused_resample.restype = i32
    lib.lanczos_shift_resample.argtypes = [ptr] * 8 + [i32] * 11 + [ptr]
    lib.lanczos_shift_resample.restype = i32
    lib.lanczos_phase_resample.argtypes = [ptr] * 10 + [i32] * 14 + [ptr]
    lib.lanczos_phase_resample.restype = i32
    lib.lanczos_phase_window.argtypes = [ptr] * 8 + [i32] * 19 + [ptr]
    lib.lanczos_phase_window.restype = i32
    lib.lanczos_phase_stream_v.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.lanczos_phase_stream_v.restype = i32
    lib.lanczos_phase_stream_h.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.lanczos_phase_stream_h.restype = i32
    lib.lanczos_ablate_fused.argtypes = [ptr] * 7 + [i32] * 16 + [ptr]
    lib.lanczos_ablate_fused.restype = i32
    lib.lanczos_cuda_error_string.argtypes = [i32]
    lib.lanczos_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().lanczos_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({code})")
