"""ctypes loader for the native oracle inner loop (``oracle.cpp``, a copy
of ``lanczos_tpu/ref/_native/oracle.cpp``).

Built at first use with ``g++ -O2 -ffp-contract=off`` into
``lanczos_torch/_build/`` by :func:`lanczos_torch.utils.native.build_library`.
Where g++ is missing or fails, :func:`native_lib` returns None and
``c_oracle_upscale`` runs its NumPy loop, which gives the same bytes.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

from lanczos_torch.utils.native import build_library

_SRC = Path(__file__).resolve().parent / "oracle.cpp"
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


def native_lib() -> Optional[_Lib]:
    """The loaded C loop, built first if needed; None where it cannot be."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build_library(_SRC, _FLAGS, "oracle")
        if so is None:
            return None
        try:
            _lib = _Lib(ctypes.CDLL(str(so)))
        except OSError:
            _lib = None
        return _lib
