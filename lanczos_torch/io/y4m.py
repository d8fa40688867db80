"""YUV4MPEG2 (.y4m) uncompressed video container, read and write.

The reference is image-only (its stb codec decodes stills,
``full_TB.h:107``), but the framework's video/streaming configs
(BASELINE.md: "240-frame 4K→8K streaming") need a frame source that a
real pipeline would use.  Y4M is the standard uncompressed testbench
container (mjpegtools/ffmpeg/x264 interchange): a one-line ASCII header
followed by ``FRAME\\n``-delimited raw planar YCbCr frames — exactly the
planar layout the CUDA kernels prefer, so frames go from file to the
fused kernel with zero relayout (a copy of ``lanczos_tpu/io/y4m.py``, which
cannot be imported without JAX).

Scope: C420 (all chroma-siting variants: 420jpeg/420mpeg2/420paldv),
C422, C444, and Cmono at 8 bits, plus the p10/p12/p14/p16 deep variants
(little-endian uint16 planes, e.g. C420p10 — the ffmpeg/x264 convention).
Interlaced files raise.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator, Optional, Sequence, Tuple, Union

import numpy as np


class Y4MError(ValueError):
    pass


_MAGIC = b"YUV4MPEG2"


def _read_exact(f: BinaryIO, n: int) -> bytes:
    """Read exactly n bytes, looping over short reads (raw streams /
    sockets may legitimately return fewer than requested per call);
    returns short only at true EOF."""
    buf = f.read(n)
    if len(buf) in (0, n):
        return buf
    chunks = [buf]
    got = len(buf)
    while got < n:
        more = f.read(n - got)
        if not more:
            break
        chunks.append(more)
        got += len(more)
    return b"".join(chunks)

# colorspace tag -> (chroma subsampling h, w) divisors; None = no chroma
_COLORSPACES = {
    "420jpeg": (2, 2),
    "420mpeg2": (2, 2),
    "420paldv": (2, 2),
    "420": (2, 2),
    "422": (1, 2),
    "444": (1, 1),
    "mono": None,
}


def _split_depth(cs: str):
    """``"420p10"`` → ``("420", 10)``; plain tags are 8-bit."""
    for suf in ("p10", "p12", "p14", "p16"):
        if cs.endswith(suf):
            return cs[: -len(suf)], int(suf[1:])
    return cs, 8


@dataclasses.dataclass(frozen=True)
class Y4MHeader:
    width: int
    height: int
    fps: Tuple[int, int] = (25, 1)
    interlace: str = "p"
    aspect: Tuple[int, int] = (0, 0)
    colorspace: str = "420jpeg"
    extensions: Tuple[str, ...] = ()

    @property
    def base_colorspace(self) -> str:
        """Colorspace tag without the pNN depth suffix (e.g. 420p10 → 420)."""
        return _split_depth(self.colorspace)[0]

    @property
    def bit_depth(self) -> int:
        return _split_depth(self.colorspace)[1]

    @property
    def sample_dtype(self) -> np.dtype:
        """uint8 for 8-bit streams, little-endian uint16 for deep ones."""
        return np.dtype(np.uint8 if self.bit_depth == 8 else "<u2")

    @property
    def chroma_shape(self) -> Optional[Tuple[int, int]]:
        div = _COLORSPACES[self.base_colorspace]
        if div is None:
            return None
        dh, dw = div
        return (self.height // dh, self.width // dw)

    @property
    def frame_bytes(self) -> int:
        n = self.width * self.height
        c = self.chroma_shape
        n = n if c is None else n + 2 * c[0] * c[1]
        return n * (1 if self.bit_depth == 8 else 2)

    def tag_line(self) -> bytes:
        parts = [
            _MAGIC.decode(),
            f"W{self.width}",
            f"H{self.height}",
            f"F{self.fps[0]}:{self.fps[1]}",
            f"I{self.interlace}",
        ]
        if self.aspect != (0, 0):
            parts.append(f"A{self.aspect[0]}:{self.aspect[1]}")
        parts.append(f"C{self.colorspace}")
        parts.extend(f"X{x}" for x in self.extensions)
        return (" ".join(parts) + "\n").encode()


def parse_header(line: bytes) -> Y4MHeader:
    """Parse the stream header line (without trailing newline)."""
    fields = line.split(b" ")
    if fields[0] != _MAGIC:
        raise Y4MError("not a YUV4MPEG2 stream")
    w = h = None
    fps, interlace, aspect, cs = (25, 1), "p", (0, 0), "420jpeg"
    ext = []
    for f in fields[1:]:
        if not f:
            continue
        tag, val = chr(f[0]), f[1:].decode("ascii", "replace")
        if tag == "W":
            w = int(val)
        elif tag == "H":
            h = int(val)
        elif tag == "F":
            n, d = val.split(":")
            fps = (int(n), int(d))
        elif tag == "I":
            interlace = val
        elif tag == "A":
            n, d = val.split(":")
            aspect = (int(n), int(d))
        elif tag == "C":
            cs = val
        elif tag == "X":
            ext.append(val)
        else:
            raise Y4MError(f"unknown y4m header tag {tag!r}")
    if w is None or h is None:
        raise Y4MError("y4m header missing W/H")
    if interlace not in ("p", "?"):
        raise Y4MError(f"interlaced y4m (I{interlace}) unsupported")
    base, depth = _split_depth(cs)
    if base not in _COLORSPACES:
        raise Y4MError(f"colorspace C{cs} unsupported")
    if depth != 8 and _COLORSPACES[base] is None:
        raise Y4MError(f"colorspace C{cs} unsupported (deep mono)")
    div = _COLORSPACES[base]
    if div is not None and (h % div[0] or w % div[1]):
        raise Y4MError(f"dims {w}x{h} not divisible for C{cs}")
    return Y4MHeader(w, h, fps, interlace, aspect, cs, tuple(ext))


Frame = Tuple[np.ndarray, ...]  # (Y,) or (Y, Cb, Cr), each (h, w) uint8


class Y4MReader:
    """Iterate frames of a .y4m file/stream as tuples of uint8 planes."""

    def __init__(self, src: Union[str, bytes, BinaryIO]):
        if isinstance(src, (str,)):
            self._f: BinaryIO = open(src, "rb")
            self._own = True
        elif isinstance(src, (bytes, bytearray)):
            import io as _io

            self._f = _io.BytesIO(src)
            self._own = True
        else:
            self._f = src
            self._own = False
        line = self._readline()
        self.header = parse_header(line)

    def _readline(self) -> bytes:
        buf = bytearray()
        while True:
            ch = self._f.read(1)
            if not ch:
                raise Y4MError("truncated y4m header")
            if ch == b"\n":
                return bytes(buf)
            buf += ch
            if len(buf) > 4096:
                raise Y4MError("y4m header line too long")

    def __iter__(self) -> Iterator[Frame]:
        hdr = self.header
        h, w = hdr.height, hdr.width
        cshape = hdr.chroma_shape
        while True:
            line = _read_exact(self._f, 5)
            if not line:
                return
            if line != b"FRAME":
                raise Y4MError(f"bad frame marker {line!r}")
            ch = self._f.read(1)
            if ch != b"\n":  # frame-level parameters (rare) — skip the line
                self._readline()
            raw = _read_exact(self._f, hdr.frame_bytes)
            if len(raw) != hdr.frame_bytes:
                raise Y4MError("truncated y4m frame")
            dt = hdr.sample_dtype
            nb = dt.itemsize
            y = np.frombuffer(raw, dt, h * w).reshape(h, w)
            if cshape is None:
                yield (y,)
                continue
            ch_, cw = cshape
            n, m = h * w, ch_ * cw
            cb = np.frombuffer(raw, dt, m, n * nb).reshape(ch_, cw)
            cr = np.frombuffer(raw, dt, m, (n + m) * nb).reshape(ch_, cw)
            yield (y, cb, cr)

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_y4m(src) -> Tuple[Y4MHeader, list]:
    """Read a whole .y4m into (header, [frame planes, ...])."""
    with Y4MReader(src) as r:
        return r.header, list(r)


class Y4MWriter:
    """Write frames (tuples of uint8 planes) to a .y4m file/stream."""

    def __init__(self, dst: Union[str, BinaryIO], header: Y4MHeader):
        if isinstance(dst, str):
            self._f: BinaryIO = open(dst, "wb")
            self._own = True
        else:
            self._f = dst
            self._own = False
        self.header = header
        self._f.write(header.tag_line())

    def write(self, frame: Sequence[np.ndarray]) -> None:
        hdr = self.header
        cshape = hdr.chroma_shape
        want = 1 if cshape is None else 3
        if len(frame) != want:
            raise Y4MError(f"C{hdr.colorspace} frame needs {want} planes")
        shapes = [(hdr.height, hdr.width)] + ([cshape] * 2 if cshape else [])
        self._f.write(b"FRAME\n")
        dt = hdr.sample_dtype
        limit = (1 << hdr.bit_depth) - 1
        for plane, shape in zip(frame, shapes):
            plane = np.asarray(plane)
            if hdr.bit_depth > 8 and plane.max(initial=0) > limit:
                raise Y4MError(
                    f"sample exceeds {hdr.bit_depth}-bit range of "
                    f"C{hdr.colorspace}"
                )
            plane = np.ascontiguousarray(plane, dt)
            if plane.shape != tuple(shape):
                raise Y4MError(f"plane shape {plane.shape} != {shape}")
            self._f.write(plane.tobytes())

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_y4m(dst, frames, fps=(25, 1), colorspace: Optional[str] = None):
    """Write frames ((Y,) or (Y, Cb, Cr) plane tuples) as .y4m.

    uint8 planes infer an 8-bit colorspace from the chroma ratio; uint16
    planes need an explicit deep ``colorspace`` (e.g. ``"420p10"``) since
    the bit depth cannot be inferred from the dtype."""
    frames = list(frames)
    if not frames:
        raise Y4MError("no frames")
    f0 = frames[0]
    h, w = f0[0].shape
    if colorspace is None and np.asarray(f0[0]).dtype != np.uint8:
        raise Y4MError(
            "deep (uint16) planes need an explicit colorspace= (e.g. "
            "'420p10'/'444p16'); the depth is not inferable from the dtype"
        )
    if colorspace is None:
        if len(f0) == 1:
            colorspace = "mono"
        else:
            ch_, cw = f0[1].shape
            ratio = (h // ch_ if ch_ and h % ch_ == 0 else 0,
                     w // cw if cw and w % cw == 0 else 0)
            tags = {(2, 2): "420jpeg", (1, 2): "422", (1, 1): "444"}
            if ratio not in tags:
                raise Y4MError(
                    f"chroma {cw}x{ch_} vs luma {w}x{h}: subsampling is not "
                    "4:2:0/4:2:2/4:4:4 — pass colorspace= explicitly"
                )
            colorspace = tags[ratio]
    hdr = Y4MHeader(w, h, fps=tuple(fps), colorspace=colorspace)
    with Y4MWriter(dst, hdr) as wr:
        for fr in frames:
            wr.write(fr)
    return hdr
