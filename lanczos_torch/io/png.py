"""PNG codec (from scratch: zlib + NumPy, native C++ fast path): the port's
copy of ``lanczos_tpu/io/png.py``.

Word for word the original below this docstring, apart from
``lanczos_tpu.io`` read as ``lanczos_torch.io``.  Inflate/deflate use
Python's zlib (C-backed); the byte-sequential unfilter/filter inner loops
run in C++ (``lanczos_torch/io/_native/pngfilter.cpp``, built with ``g++``
at first use) loaded via ctypes, with a NumPy fallback that vectorizes
what it can (None/Sub/Up fully, Average/Paeth per pixel along the row) and
gives the same bytes.

Supported: 8-bit greyscale, grey+alpha, RGB, RGBA, and paletted PNGs,
sequential AND Adam7-interlaced.  16-bit channels are read and narrowed
to 8 with an explicit ``>> 8`` by :func:`decode`, or kept at full width
by :func:`decode16` (the ``stbi_load_16`` analog).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from lanczos_torch.io._native import native_lib

_SIG = b"\x89PNG\r\n\x1a\n"

_COLOR_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGError(ValueError):
    pass


def _codec(fn):
    from lanczos_torch.io.formats import codec_errors

    return codec_errors(PNGError)(fn)


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        yield ctype, body
        pos += 12 + length  # length + type + crc
        if ctype == b"IEND":
            return


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    # a=left, b=up, c=up-left; int16 arithmetic to avoid uint8 wrap
    p = a.astype(np.int16) + b.astype(np.int16) - c.astype(np.int16)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(
        np.uint8
    )


def _unfilter_numpy(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """raw: (h, 1+stride) filtered scanlines → (h, stride) reconstructed."""
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ft = int(raw[y, 0])
        line = raw[y, 1:].copy()
        if ft == 0:
            rec = line
        elif ft == 1:  # Sub: cumulative sum per byte lane with stride bpp
            rec = line.reshape(-1, bpp)
            np.cumsum(rec, axis=0, dtype=np.uint8, out=rec)  # uint8 wraps
            rec = rec.reshape(-1)
        elif ft == 2:  # Up
            rec = line + prev
        elif ft == 3:  # Average
            rec = line
            for x in range(stride):
                left = int(rec[x - bpp]) if x >= bpp else 0
                rec[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            rec = line
            for x in range(stride):
                a = int(rec[x - bpp]) if x >= bpp else 0
                c = int(prev[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise PNGError(f"bad filter type {ft} on scanline {y}")
        out[y] = rec
        prev = out[y]
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    lib = native_lib()
    if lib is not None:
        buf = np.ascontiguousarray(raw)
        out = np.empty((h, stride), dtype=np.uint8)
        rc = lib.png_unfilter(
            buf.ctypes.data_as(lib.u8p),
            out.ctypes.data_as(lib.u8p),
            h,
            stride,
            bpp,
        )
        if rc != 0:
            raise PNGError(f"bad filter type (native rc={rc})")
        return out
    return _unfilter_numpy(raw, h, stride, bpp)


# Adam7 interlace passes: (x0, y0, dx, dy) per the PNG spec
_ADAM7 = [
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
]


def _pass_geometry(w: int, h: int, depth: int, nchan: int):
    if depth < 8:
        return lambda pw: ((pw * depth + 7) // 8, 1)
    bpp = nchan * (depth // 8)
    return lambda pw: (pw * bpp, bpp)


def _rows_to_samples(
    rec: np.ndarray, w: int, nchan: int, depth: int, color: int,
    want16: bool = False,
) -> np.ndarray:
    """Unfiltered byte rows (h, stride) → (h, w, nchan) samples.

    uint8 by default; with ``want16`` uint16 (native for depth-16 sources,
    promoted ``v * 257`` otherwise, matching stb's 8→16 promotion)."""
    h = rec.shape[0]
    if depth == 16:
        pairs = rec.reshape(h, w, nchan, 2).astype(np.uint16)
        if want16:
            return (pairs[..., 0] << 8) | pairs[..., 1]  # big-endian
        return pairs[..., 0].astype(np.uint8)  # high byte == >> 8
    if want16:
        v8 = _rows_to_samples(rec, w, nchan, depth, color)
        return v8.astype(np.uint16) * 257
    if depth < 8:
        bits = np.unpackbits(rec, axis=1)  # (h, stride*8), MSB first
        samples = bits.reshape(h, -1, depth)[:, :w, :]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (samples * weights).sum(axis=2).astype(np.uint8)
        if color == 0:  # scale to full 8-bit range per the spec
            vals = (vals * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return vals[:, :, None]
    return rec.reshape(h, w, nchan)


@_codec
def probe(data: bytes):
    """Header-only probe (stbi_info analog) → ``(w, h, channels, bits)``.

    *channels* is what :func:`decode` would return: palette entries expand
    to RGB (or RGBA when a tRNS chunk is present)."""
    if data[:8] != _SIG:
        raise PNGError("not a PNG (bad signature)")
    ihdr = None
    trns = False
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"tRNS":
            trns = True
        elif ctype == b"IDAT":
            break
    if ihdr is None:
        raise PNGError("missing IHDR")
    w, h, depth, color, _comp, _filt, _inter = ihdr
    if color not in _COLOR_CHANNELS:
        raise PNGError(f"bad color type {color}")
    if color == 3:
        return (w, h, 4 if trns else 3, 8)
    extra = 1 if (trns and color in (0, 2)) else 0  # color-key alpha
    return (w, h, _COLOR_CHANNELS[color] + extra, depth if depth == 16 else 8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8 (C ∈ {1, 2, 3, 4}).

    Supports non-interlaced and Adam7-interlaced images (the latter closing
    the stb ingest gap noted in the round-1 verdict)."""
    return _decode(data, want16=False)


@_codec
def decode16(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint16 — the ``stbi_load_16`` analog.

    Depth-16 sources decode natively; shallower depths (and palette
    entries) are promoted ``v * 257`` exactly as stb does."""
    return _decode(data, want16=True)


@_codec
def _decode(data: bytes, want16: bool) -> np.ndarray:
    if data[:8] != _SIG:
        raise PNGError("not a PNG (bad signature)")
    ihdr = None
    palette = None
    trns = None
    idat = []
    is_iphone = False
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"CgBI":  # iPhone PNG (stb_image.h:5043-5046)
            is_iphone = True
    if ihdr is None or not idat:
        raise PNGError("missing IHDR or IDAT")
    w, h, depth, color, comp, filt, interlace = ihdr
    from lanczos_torch.io.formats import check_dims

    check_dims(w, h)
    if comp != 0 or filt != 0:
        raise PNGError("unsupported compression/filter method")
    if interlace not in (0, 1):
        raise PNGError(f"bad interlace method {interlace}")
    if color not in _COLOR_CHANNELS:
        raise PNGError(f"bad color type {color}")
    if depth not in (1, 2, 4, 8, 16) or (depth < 8 and color not in (0, 3)):
        raise PNGError(f"unsupported bit depth {depth} for color type {color}")
    nchan = _COLOR_CHANNELS[color]
    geom = _pass_geometry(w, h, depth, nchan)
    # palette indices always decode as 8-bit; promotion happens after lookup
    w16 = want16 and color != 3
    sdt = np.uint16 if w16 else np.uint8
    blob = b"".join(idat)
    # CgBI strips the zlib header/adler — raw deflate (stb inflates with
    # parse_header = !is_iphone, stb_image.h:5143)
    raw = np.frombuffer(
        zlib.decompress(blob, -15) if is_iphone else zlib.decompress(blob),
        np.uint8,
    )
    if interlace == 0:
        stride, bpp = geom(w)
        if raw.size != h * (stride + 1):
            raise PNGError(
                f"decompressed size {raw.size} != {h * (stride + 1)}"
            )
        rec = _unfilter(raw.reshape(h, stride + 1), h, stride, bpp)
        img = _rows_to_samples(rec, w, nchan, depth, color, w16)
    else:  # Adam7: 7 independently-filtered sub-images, composited
        img = np.zeros((h, w, nchan), sdt)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = -(-(w - x0) // dx) if w > x0 else 0
            ph = -(-(h - y0) // dy) if h > y0 else 0
            if pw == 0 or ph == 0:
                continue
            stride, bpp = geom(pw)
            n = ph * (stride + 1)
            if pos + n > raw.size:
                raise PNGError("truncated interlaced data")
            rec = _unfilter(
                raw[pos : pos + n].reshape(ph, stride + 1), ph, stride, bpp
            )
            pos += n
            img[y0::dy, x0::dx] = _rows_to_samples(
                rec, pw, nchan, depth, color, w16
            )
    if color == 3:
        if palette is None:
            raise PNGError("paletted PNG without PLTE")
        pal_idx = img[..., 0]
        img = palette[pal_idx]
        if trns is not None:
            a = np.full(palette.shape[0], 255, np.uint8)
            a[: trns.size] = trns
            img = np.concatenate([img, a[pal_idx][..., None]], axis=-1)
        if want16:
            img = img.astype(np.uint16) * 257
    elif trns is not None and color in (0, 2):
        # color-key transparency (stbi__compute_transparency): tRNS holds
        # one big-endian 16-bit sample per channel; exact matches become
        # alpha 0, everything else fully opaque
        key = np.frombuffer(trns.tobytes(), ">u2").astype(np.uint32)[
            : img.shape[2]
        ]
        # the key must go through the same sample transform as the pixels:
        # depth<8 scales to the 8-bit range, 8-bit keeps the low byte
        # (stb's convention), and want16 promotes x257 for sub-16 depths
        if depth < 8:
            key = key * (255 // ((1 << depth) - 1))
        elif depth == 8:
            key = key & 255
        if want16 and depth < 16:
            key = key * 257
        keyv = key.astype(img.dtype)
        match = np.all(img == keyv[None, None, :], axis=2)
        full = np.array(65535 if want16 else 255, img.dtype)
        alpha = np.where(match, img.dtype.type(0), full)
        img = np.concatenate([img, alpha[..., None]], axis=2)
    if is_iphone and _de_iphone_flag and img.shape[-1] > 2:
        img = _de_iphone(img)
    return np.ascontiguousarray(img)


# stb's iPhone-PNG post-processing flags (stbi_convert_iphone_png_to_rgb /
# stbi_set_unpremultiply_on_load, stb_image.h:4941-4949).  Both default
# OFF exactly as in stb: a CgBI file then decodes to its on-disk BGR,
# premultiplied-alpha samples.
_de_iphone_flag = False
_unpremultiply_on_load = False


def convert_iphone_png_to_rgb(flag: bool) -> None:
    global _de_iphone_flag
    _de_iphone_flag = bool(flag)


def set_unpremultiply_on_load(flag: bool) -> None:
    global _unpremultiply_on_load
    _unpremultiply_on_load = bool(flag)


def _de_iphone(img: np.ndarray) -> np.ndarray:
    """BGR→RGB swap (+ optional round-to-nearest unpremultiply at 4
    channels), matching ``stbi__de_iphone`` (stb_image.h:4978-5020)."""
    img = img[..., [2, 1, 0, 3][: img.shape[-1]]].astype(img.dtype)
    if img.shape[-1] == 4 and _unpremultiply_on_load:
        a = img[..., 3].astype(np.uint32)
        rgb = img[..., :3].astype(np.uint32)
        un = ((rgb * 255 + (a // 2)[..., None]) // np.maximum(a, 1)[..., None])
        img = img.copy()
        img[..., :3] = np.where(
            (a > 0)[..., None], un, rgb
        ).astype(img.dtype)
    return img


def _filter_scanlines_numpy(img2d: np.ndarray, bpp: int) -> bytes:
    """Per-scanline adaptive filtering (minimum-sum-of-absolutes heuristic),
    restricted to filters {0 None, 1 Sub, 2 Up} which NumPy computes
    vectorized; the native path also tries Average/Paeth."""
    h, stride = img2d.shape
    prev = np.zeros(stride, np.uint8)
    out = bytearray()
    for y in range(h):
        line = img2d[y]
        sub = line.copy()
        sub[bpp:] = line[bpp:] - line[:-bpp]
        up = line - prev
        cands = ((0, line), (1, sub), (2, up))
        scores = [
            np.abs(c.astype(np.int8).astype(np.int16)).sum() for _, c in cands
        ]
        ft, best = cands[int(np.argmin(scores))]
        out.append(ft)
        out += best.tobytes()
        prev = line
    return bytes(out)


def _filter_scanlines(img2d: np.ndarray, bpp: int, level: int) -> bytes:
    lib = native_lib()
    h, stride = img2d.shape
    if lib is not None:
        src = np.ascontiguousarray(img2d)
        out = np.empty(h * (stride + 1), dtype=np.uint8)
        lib.png_filter(
            src.ctypes.data_as(lib.u8p),
            out.ctypes.data_as(lib.u8p),
            h,
            stride,
            bpp,
            1 if level > 1 else 0,
        )
        return out.tobytes()
    return _filter_scanlines_numpy(img2d, bpp)


def encode(img: np.ndarray, compress_level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8 → PNG bytes (C ∈ {1, 2, 3, 4})."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise PNGError(f"encode expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise PNGError(f"bad image shape {img.shape}")
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    img2d = np.ascontiguousarray(img).reshape(h, w * c)
    filtered = _filter_scanlines(img2d, c, compress_level)
    comp = zlib.compress(filtered, compress_level)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return _SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", comp) + chunk(b"IEND", b"")


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write_png(path, img: np.ndarray, compress_level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, compress_level))
