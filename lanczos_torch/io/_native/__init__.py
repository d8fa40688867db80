"""ctypes loader for the image codecs' native inner loops: copies of
``lanczos_tpu/io/_native/``'s ``pngfilter.cpp`` (PNG scanline unfilter and
filter), ``jpegdec.cpp`` (JPEG entropy decode, dequantization and IDCT) and
``gif_lzw.cpp`` (GIF LZW decode and encode).

Each is built at first use with ``g++ -O3 -shared -fPIC`` into
``lanczos_torch/_build/`` by :func:`lanczos_torch.utils.native.build_library`
(named by a hash of the source, renamed into place), never beside its
source.  As in the JAX package, :func:`native_lib` returns None when the PNG
library cannot be built, and a library without the JPEG or GIF symbols when
only those fail: callers then take their NumPy paths (PNG and GIF, the same
bytes) or raise (JPEG decode).  :func:`native_paths` says which ran.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

from lanczos_torch.utils.native import build_library

_HERE = Path(__file__).resolve().parent
_FLAGS = ["-O3", "-shared", "-fPIC"]
_SOURCES = {"pngfilter": "pngfilter.cpp", "jpegdec": "jpegdec.cpp", "giflzw": "gif_lzw.cpp"}

_lock = threading.Lock()
_lib = None
_tried = False


class _Lib:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def __init__(self, cdll: ctypes.CDLL, jpeg_cdll=None, lzw_cdll=None):
        self._cdll = cdll
        cdll.png_unfilter.restype = ctypes.c_int
        cdll.png_unfilter.argtypes = [
            self.u8p, self.u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int
        ]
        cdll.png_filter.restype = None
        cdll.png_filter.argtypes = [
            self.u8p, self.u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        self.png_unfilter = cdll.png_unfilter
        self.png_filter = cdll.png_filter
        if jpeg_cdll is not None:
            jpeg_cdll.jpeg_decode_scan.restype = ctypes.c_int
            jpeg_cdll.jpeg_decode_scan.argtypes = [
                self.u8p, ctypes.c_long, ctypes.c_int, self.i32p, self.i32p,
                self.i32p, self.i32p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(self.u8p), self.i32p,
            ]
            self.jpeg_decode_scan = jpeg_cdll.jpeg_decode_scan
            jpeg_cdll.jpeg_decode_prog_scan.restype = ctypes.c_int
            jpeg_cdll.jpeg_decode_prog_scan.argtypes = [
                self.u8p, ctypes.c_long, ctypes.c_int, self.i32p,
                self.i32p, self.i32p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(self.i32p),
            ]
            self.jpeg_decode_prog_scan = jpeg_cdll.jpeg_decode_prog_scan
            jpeg_cdll.jpeg_finish_prog.restype = ctypes.c_int
            jpeg_cdll.jpeg_finish_prog.argtypes = [
                self.i32p, self.i32p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, self.u8p, ctypes.c_long,
            ]
            self.jpeg_finish_prog = jpeg_cdll.jpeg_finish_prog
        if lzw_cdll is not None:
            lzw_cdll.gif_lzw_decode.restype = ctypes.c_long
            lzw_cdll.gif_lzw_decode.argtypes = [
                self.u8p, ctypes.c_long, ctypes.c_int, self.u8p,
                ctypes.c_long,
            ]
            self.gif_lzw_decode = lzw_cdll.gif_lzw_decode
            lzw_cdll.gif_lzw_encode.restype = ctypes.c_long
            lzw_cdll.gif_lzw_encode.argtypes = [
                self.u8p, ctypes.c_long, ctypes.c_int, self.u8p,
                ctypes.c_long,
            ]
            self.gif_lzw_encode = lzw_cdll.gif_lzw_encode


def _load(stem: str) -> Optional[ctypes.CDLL]:
    so = build_library(_HERE / _SOURCES[stem], _FLAGS, stem)
    if so is None:
        return None
    try:
        return ctypes.CDLL(str(so))
    except OSError:
        return None


def native_lib() -> Optional[_Lib]:
    """The loaded native library, building it on first use; None if
    unavailable (callers fall back to NumPy)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        png = _load("pngfilter")
        if png is not None:
            _lib = _Lib(png, _load("jpegdec"), _load("giflzw"))
        return _lib


def native_paths() -> dict:
    """Which codec loops run natively (True) and which in NumPy (False;
    JPEG decode raises then)."""
    lib = native_lib()
    return {
        "png": lib is not None,
        "jpeg": hasattr(lib, "jpeg_decode_scan"),
        "gif": hasattr(lib, "gif_lzw_decode"),
    }
