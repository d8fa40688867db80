"""ctypes loader for the native oracle inner loop (``oracle.cpp``, a copy
of ``lanczos_tpu/ref/_native/oracle.cpp``).

Built at first use with ``g++ -O2 -ffp-contract=off`` into
``lanczos_torch/_build/``, named by a hash of the source, and renamed into
place so that concurrent builds never load a half-written library.  Where
g++ is missing or fails, :func:`native_lib` returns None and
``c_oracle_upscale`` runs its NumPy loop, which gives the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "oracle.cpp"
_BUILD = Path(__file__).resolve().parent.parent.parent / "_build"
_FLAGS = ["-O2", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


class _Lib:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)

    def __init__(self, cdll: ctypes.CDLL):
        cdll.oracle_height_pass.restype = None
        cdll.oracle_height_pass.argtypes = [
            self.u8p, ctypes.c_int, ctypes.c_long, self.i32p, self.f64p,
            ctypes.c_int,
        ]
        self.oracle_height_pass = cdll.oracle_height_pass


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD / f"liboracle_{h.hexdigest()[:16]}.so"


def native_lib() -> Optional[_Lib]:
    """The loaded C loop, built first if needed; None where it cannot be."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _library_path()
        if not so.exists():
            try:
                _BUILD.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
                    out = os.path.join(tmp, so.name)
                    subprocess.run(
                        ["g++", *_FLAGS, "-o", out, str(_SRC)],
                        check=True, capture_output=True, timeout=120,
                    )
                    os.replace(out, so)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            _lib = _Lib(ctypes.CDLL(str(so)))
        except OSError:
            _lib = None
        return _lib
