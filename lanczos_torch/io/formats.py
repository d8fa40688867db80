"""BMP / TGA / PNM / GIF / PSD / HDR / PIC codecs (pure NumPy, from the
format specs): the port's copy of ``lanczos_tpu/io/formats.py``.

Word for word the original below this docstring, apart from
``lanczos_tpu.io`` read as ``lanczos_torch.io`` (the native library is the
port's, :mod:`lanczos_torch.io._native`).  The Radiance header it writes
still names ``lanczos_tpu``, so both packages write the same bytes.
Host code only: nothing here touches torch or the card.

Together with the PNG and JPEG modules this covers the reference's FULL
stb ingest surface (``stb_image.h`` decodes JPEG/PNG/BMP/TGA/GIF/PSD/
HDR/PIC/PNM) plus the write side stb_image_write.h lacks for some of
them.

Scope:
- BMP: uncompressed 1/4/8-bit paletted, 16-bit (555 or BITFIELDS
  masks), 24/32-bit, bottom-up or top-down rows (stb's exact scope:
  no RLE).
- TGA: types 1/2 (uncompressed palette/truecolor), 9/10 (RLE), 8/16/24/32
  bpp, origin handling.
- PNM: binary P5 (gray) and P6 (RGB), maxval ≤ 65535.
- GIF: 87a/89a first frame, LZW decode, interlace, global/local palettes,
  transparency → alpha channel.
- PSD: version-1 RGB composites, 8/16-bit, raw or PackBits RLE.
- HDR: Radiance RGBE decode (flat / old RLE / component RLE) + encode,
  with stb's gamma-2.2 HDR↔LDR conversions.
- PIC: Softimage, uncompressed / pure-RLE / mixed-RLE packets.

:func:`encode_gif` packs sizes and delays as 16-bit fields and raises
``struct.error`` above 65535; :func:`lanczos_torch.io.encode_gif` checks
them first.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np


class FormatError(ValueError):
    pass


_MAX_DIM = 1 << 24  # stb's STBI_MAX_DIMENSIONS default


def check_dims(w: int, h: int) -> None:
    """Reject implausible header dimensions BEFORE any allocation sized by
    them (stb's STBI_MAX_DIMENSIONS guard)."""
    if not (0 < w <= _MAX_DIM and 0 < h <= _MAX_DIM):
        raise FormatError(f"implausible image dimensions {w}x{h}")


def codec_errors(err_type):
    """Normalize stray parse failures to the codec's typed error.

    stb's contract is that corrupt bytes yield a NULL + error string, never
    a crash; the Python analog is "always raises a :class:`ValueError`
    subclass", never a raw ``IndexError`` / ``struct.error`` /
    ``zlib.error`` escaping from offset arithmetic on truncated data.
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except err_type:
                raise
            except (
                IndexError,
                KeyError,
                struct.error,
                ValueError,
                OverflowError,
                zlib.error,
            ) as e:
                raise err_type(
                    f"{fn.__name__}: corrupt or truncated input "
                    f"({type(e).__name__}: {e})"
                ) from e

        return wrapper

    return deco


_codec = codec_errors(FormatError)


# ---------------------------------------------------------------- BMP

# stb's bit-replication channel expansion (stb_image.h:5331-5348): align
# the mask's top bit to bit 7, keep the top `bits` bits, then replicate
# them across the byte with a multiply+shift.  Differs from (v*255)//maxv
# by 1 LSB on some values (e.g. 5-bit 16 -> 132, not 131).
_SHIFTSIGNED_MUL = (0, 0xFF, 0x55, 0x49, 0x11, 0x21, 0x41, 0x81, 0x01)
_SHIFTSIGNED_SHIFT = (0, 0, 0, 1, 0, 2, 4, 6, 0)


def _shiftsigned(px: np.ndarray, mask: int) -> np.ndarray:
    bits = bin(mask).count("1")
    if mask == 0 or bits > 8:
        raise FormatError(f"BMP bitfields mask {mask:#x} unsupported")
    shift = mask.bit_length() - 8  # high_bit(mask) - 7
    v = px & np.uint32(mask)
    v = (v >> shift) if shift >= 0 else (v << -shift)
    v >>= 8 - bits
    return ((v * _SHIFTSIGNED_MUL[bits]) >> _SHIFTSIGNED_SHIFT[bits]).astype(
        np.uint8
    )


@_codec
def decode_bmp(data: bytes) -> np.ndarray:
    if data[:2] != b"BM":
        raise FormatError("not a BMP")
    (pix_off,) = struct.unpack("<I", data[10:14])
    (hdr_size,) = struct.unpack("<I", data[14:18])
    if hdr_size < 40:
        raise FormatError("BMP core header unsupported")
    w, h = struct.unpack("<ii", data[18:26])
    planes, bpp = struct.unpack("<HH", data[26:30])
    (comp,) = struct.unpack("<I", data[30:34])
    if comp not in (0, 3):  # BI_RGB / BI_BITFIELDS(with default masks)
        raise FormatError(f"BMP compression {comp} unsupported")
    if comp == 3 and bpp not in (16, 32):
        # stb rejects BITFIELDS outside 16/32 bpp ("bad BMP") instead of
        # silently ignoring the masks (stb_image.h bmp_parse_header)
        raise FormatError(f"BMP BITFIELDS with {bpp} bpp unsupported")
    top_down = h < 0
    h = abs(h)
    check_dims(w, h)
    if bpp in (1, 4, 8):  # paletted (stb reads 1/4/8-bit, no RLE)
        (ncol,) = struct.unpack("<I", data[46:50])
        ncol = ncol or (1 << bpp)
        pal = np.frombuffer(
            data[14 + hdr_size : 14 + hdr_size + 4 * ncol], np.uint8
        ).reshape(-1, 4)[:, [2, 1, 0]]  # BGRX -> RGB
        stride = ((w * bpp + 31) // 32) * 4  # rows pad to 4 bytes
        rows = np.frombuffer(
            data[pix_off : pix_off + stride * h], np.uint8
        ).reshape(h, stride)
        if bpp == 8:
            idx = rows[:, :w]
        else:
            bits = np.unpackbits(rows, axis=1)  # MSB-first per the format
            samples = bits.reshape(h, -1, bpp)[:, :w, :]
            weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
            idx = (samples * weights).sum(axis=2)
        img = pal[idx]
    elif bpp in (16, 24, 32):
        # mask set, exactly as stbi__bmp_set_mask_defaults / BITFIELDS
        if comp == 3:
            mr, mg, mb = struct.unpack("<III", data[54:66])
            ma = (
                struct.unpack("<I", data[66:70])[0]
                if hdr_size >= 56 else 0
            )
        elif bpp == 16:
            mr, mg, mb, ma = 0x7C00, 0x03E0, 0x001F, 0
        elif bpp == 32:
            mr, mg, mb, ma = 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000
        else:
            mr = mg = mb = ma = 0
        # stb's "easy" fast paths: 24-bit always; 32-bit ONLY when the
        # full BGRA default mask set matches INCLUDING alpha
        # (stb_image.h:5586-5589)
        easy = bpp == 24 or (
            bpp == 32
            and (mr, mg, mb, ma)
            == (0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
        )
        if easy:
            nb = bpp // 8
            stride = (w * nb + 3) & ~3
            rows = np.frombuffer(
                data[pix_off : pix_off + stride * h], np.uint8
            )
            px = rows.reshape(h, stride)[:, : w * nb].reshape(h, w, nb)
            img = px[:, :, [2, 1, 0, 3][: (4 if nb == 4 else 3)]]
        else:
            nb = bpp // 8
            stride = (w * nb + 3) & ~3
            rows = np.frombuffer(
                data[pix_off : pix_off + stride * h], np.uint8
            ).reshape(h, stride)[:, : w * nb]
            px = (
                np.ascontiguousarray(rows)
                .reshape(h, w, nb)
                .view("<u2" if bpp == 16 else "<u4")[..., 0]
                .astype(np.uint32)
            )
            chans = [_shiftsigned(px, m) for m in (mr, mg, mb)]
            # stb: img_n = ma ? 4 : 3 (alpha channel only when an alpha
            # mask exists, stb_image.h:5476)
            if ma:
                chans.append(_shiftsigned(px, ma))
            img = np.stack(chans, axis=-1)
        if img.shape[-1] == 4 and not img[..., 3].any():
            # stb's all_a quirk (stb_image.h:5631-5634): an all-zero
            # alpha channel is rewritten to fully opaque
            img = img.copy()
            img[..., 3] = 255
    else:
        raise FormatError(f"BMP bpp {bpp} unsupported")
    if not top_down:
        img = img[::-1]
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------- TGA


@_codec
def decode_tga(data: bytes) -> np.ndarray:
    idlen, cmap_type, imgtype = data[0], data[1], data[2]
    cmap_start, cmap_len = struct.unpack("<HH", data[3:7])
    cmap_bpp = data[7]
    w, h = struct.unpack("<HH", data[12:16])
    check_dims(w, h)
    bpp, desc = data[16], data[17]
    if imgtype not in (1, 2, 3, 9, 10, 11):
        raise FormatError(f"TGA type {imgtype} unsupported")
    pos = 18 + idlen
    pal = None
    if cmap_type:
        nb = cmap_bpp // 8
        pal_raw = np.frombuffer(
            data[pos : pos + cmap_len * nb], np.uint8
        ).reshape(cmap_len, nb)
        pal = _tga_px_to_rgb(pal_raw, cmap_bpp)
        pos += cmap_len * nb
    nb = max(bpp // 8, 1)
    count = w * h
    if imgtype >= 9:  # RLE
        out = np.empty((count, nb), np.uint8)
        buf = np.frombuffer(data[pos:], np.uint8)
        i = 0
        o = 0
        while o < count:
            hdr = int(buf[i])
            i += 1
            n = (hdr & 0x7F) + 1
            if hdr & 0x80:
                out[o : o + n] = buf[i : i + nb]
                i += nb
            else:
                out[o : o + n] = buf[i : i + n * nb].reshape(n, nb)
                i += n * nb
            o += n
        px = out
    else:
        px = np.frombuffer(data[pos : pos + count * nb], np.uint8).reshape(
            count, nb
        )
    if imgtype in (1, 9):  # palette indices
        if pal is None:
            raise FormatError("paletted TGA without color map")
        img = pal[px[:, 0].astype(np.int32) - cmap_start]
    elif imgtype in (3, 11):  # grayscale
        img = px[:, :1]
    else:
        img = _tga_px_to_rgb(px, bpp)
    img = img.reshape(h, w, -1)
    if not (desc & 0x20):  # bottom-up origin
        img = img[::-1]
    if desc & 0x10:  # right-to-left
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def _tga_px_to_rgb(px: np.ndarray, bpp: int) -> np.ndarray:
    if bpp == 32:
        return px[:, [2, 1, 0, 3]]
    if bpp == 24:
        return px[:, [2, 1, 0]]
    if bpp in (15, 16):
        v = px[:, 0].astype(np.uint16) | (px[:, 1].astype(np.uint16) << 8)
        r = ((v >> 10) & 31).astype(np.uint8)
        g = ((v >> 5) & 31).astype(np.uint8)
        b = (v & 31).astype(np.uint8)
        scale = lambda c: ((c.astype(np.uint16) * 255 + 15) // 31).astype(np.uint8)
        return np.stack([scale(r), scale(g), scale(b)], -1)
    if bpp == 8:
        return px[:, :1]
    raise FormatError(f"TGA bpp {bpp} unsupported")


# ---------------------------------------------------------------- PNM


def _pnm_header(data: bytes):
    """Parse the PNM header tokens (skipping comments), bounds-guarded.

    Returns ``(pos, [w, h, maxval])`` with ``pos`` just past the single
    whitespace that terminates the maxval.  The explicit end-of-data
    checks are load-bearing: ``b"".isspace()`` is False, so an unguarded
    token walk spins forever on truncated headers (found by fuzzing)."""
    pos, vals = 2, []
    while len(vals) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if pos >= len(data):
            raise FormatError("truncated PNM header")
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        vals.append(int(data[start:pos]))
    return pos + 1, vals  # single whitespace after maxval


@_codec
def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PNM → (H, W, 1|3) uint8, stb semantics: sample bytes are
    returned RAW (the header maxval only selects the 8- vs 16-bit width
    and must be ≤ 65535, ``stbi__pnm_info``); 16-bit samples narrow with
    a plain ``>> 8`` (``stbi__convert_16_to_8``), NOT ``*255//maxval``."""
    if data[:2] not in (b"P5", b"P6"):
        raise FormatError("only binary PNM (P5/P6) supported")
    nchan = 1 if data[:2] == b"P5" else 3
    pos, (w, h, maxval) = _pnm_header(data)
    check_dims(w, h)
    if not 0 < maxval <= 65535:
        raise FormatError(f"bad PNM maxval {maxval}")
    if maxval < 256:
        img = np.frombuffer(data[pos : pos + w * h * nchan], np.uint8)
    else:
        raw = np.frombuffer(data[pos : pos + 2 * w * h * nchan], ">u2")
        img = (raw >> 8).astype(np.uint8)
    return img.reshape(h, w, nchan).copy()


@_codec
def decode_pnm16(data: bytes) -> np.ndarray:
    """Binary PNM at full width → (H, W, 1|3) uint16 (stbi_load_16 analog).

    stb semantics: 16-bit samples are returned RAW (the header maxval is
    never used for scaling, only width selection — ``stbi__pnm_load``);
    maxval < 256 sources return exactly ``decode_pnm(data) * 257``
    (``stbi__convert_8_to_16``'s ``(v << 8) | v`` promotion)."""
    if data[:2] not in (b"P5", b"P6"):
        raise FormatError("only binary PNM (P5/P6) supported")
    nchan = 1 if data[:2] == b"P5" else 3
    pos, vals = _pnm_header(data)
    w, h, maxval = vals
    check_dims(w, h)
    if not 0 < maxval <= 65535:
        raise FormatError(f"bad PNM maxval {maxval}")
    if maxval < 256:
        return decode_pnm(data).astype(np.uint16) * 257
    raw = np.frombuffer(data[pos : pos + 2 * w * h * nchan], ">u2")
    return raw.astype(np.uint16).reshape(h, w, nchan).copy()


# ---------------------------------------------------------------- GIF


def _lzw_decode(data: bytes, min_code_size: int, npixels: int) -> np.ndarray:
    """GIF-flavored LZW: strings kept as (prefix code, tail byte) chains.

    The bit-serial inner loop runs in C++ when the native library is
    available (``_native/gif_lzw.cpp``; 1080p GIF decode ~6 s pure-Python
    → ~0.1 s) with this implementation as the behavior-identical
    fallback."""
    from lanczos_torch.io._native import native_lib

    if not (1 <= min_code_size <= 11):
        # spec range is 2-8 (palette sizes); >11 would overflow the
        # 12-bit code space and, unchecked, the native dictionary arrays
        raise FormatError(f"bad LZW min code size {min_code_size}")
    lib = native_lib()
    if lib is not None and hasattr(lib, "gif_lzw_decode"):
        buf = np.frombuffer(data, np.uint8)
        out = np.empty(npixels, np.uint8)
        rc = lib.gif_lzw_decode(
            buf.ctypes.data_as(lib.u8p), buf.size, min_code_size,
            out.ctypes.data_as(lib.u8p), npixels,
        )
        if rc == -1:
            raise FormatError("corrupt LZW stream (bad first code)")
        if rc < 0:
            raise FormatError("corrupt LZW stream")
        if rc < npixels:
            raise FormatError(
                f"truncated GIF image data: {rc}/{npixels} pixels decoded"
            )
        return out
    clear = 1 << min_code_size
    eoi = clear + 1
    out = np.empty(npixels, np.uint8)
    n_out = 0
    prefix = [-1] * 4096
    tail = [0] * 4096
    first = [0] * 4096
    for c in range(clear):
        tail[c] = first[c] = c

    bitpos = 0
    total_bits = len(data) * 8

    def read_code(size):
        nonlocal bitpos
        if bitpos + size > total_bits:
            return eoi
        byte0 = bitpos >> 3
        v = int.from_bytes(data[byte0 : byte0 + 3], "little")
        v = (v >> (bitpos & 7)) & ((1 << size) - 1)
        bitpos += size
        return v

    def expand(c):
        stack = bytearray()
        while c >= 0:
            stack.append(tail[c])
            c = prefix[c]
        stack.reverse()
        return stack

    code_size = min_code_size + 1
    next_code = eoi + 1
    prev = -1
    while n_out < npixels:
        code = read_code(code_size)
        if code == clear:
            code_size = min_code_size + 1
            next_code = eoi + 1
            prev = -1
            continue
        if code == eoi:
            break  # early EOI: truncation check below
        if prev < 0:
            if code >= clear:
                raise FormatError("corrupt LZW stream (bad first code)")
            out[n_out] = first[code]
            n_out += 1
            prev = code
            continue
        if code < next_code:
            seq = expand(code)
            new_tail = seq[0]
        elif code == next_code:  # KwKwK
            seq = expand(prev)
            seq.append(first[prev])
            new_tail = seq[0]
        else:
            raise FormatError("corrupt LZW stream")
        n = min(len(seq), npixels - n_out)
        out[n_out : n_out + n] = np.frombuffer(bytes(seq[:n]), np.uint8)
        n_out += n
        if next_code < 4096:
            prefix[next_code] = prev
            tail[next_code] = new_tail
            first[next_code] = first[prev]
            next_code += 1
            if next_code == (1 << code_size) and code_size < 12:
                code_size += 1
        prev = code
    if n_out < npixels:
        # a truncated stream exhausts the bits (read_code returns a
        # synthetic EOI) — raising beats returning np.empty garbage rows
        raise FormatError(
            f"truncated GIF image data: {n_out}/{npixels} pixels decoded"
        )
    return out


@_codec
def decode_gif(data: bytes) -> np.ndarray:
    """First GIF frame → (H, W, 3|4) uint8 (alpha iff frame transparency)."""
    try:
        for w, h, _screen, fr in _gif_walk(data):
            x0, y0, idx, pal, transparent, _delay, _disp = fr
            rgb = pal[idx]
            if transparent is not None:
                a = np.where(idx == transparent, 0, 255).astype(np.uint8)
                rgb = np.concatenate([rgb, a[..., None]], -1)
            # composite into the full logical-screen canvas if offset
            if (x0, y0, idx.shape[1], idx.shape[0]) != (0, 0, w, h):
                c = rgb.shape[-1]
                canvas = np.zeros((h, w, c), np.uint8)
                canvas[y0 : y0 + idx.shape[0], x0 : x0 + idx.shape[1]] = rgb
                rgb = canvas
            return np.ascontiguousarray(rgb)
    except (IndexError, struct.error) as e:
        # running off the end of the byte stream mid-structure is a
        # truncated/corrupt file, not an internal error
        raise FormatError(f"truncated GIF: {e}") from e
    raise FormatError("GIF contains no image")


@_codec
def decode_gif_frames(data: bytes) -> tuple[np.ndarray, list[int]]:
    """All GIF frames, composited — the ``stbi_load_gif_from_memory``
    analog (``stb_image.h``'s two-layer canvas accumulation).

    Returns ``(frames, delays)``: frames is (N, H, W, 4) uint8 RGBA on the
    full logical screen with inter-frame disposal applied; delays are
    per-frame display times in milliseconds (GIF stores centiseconds; stb
    also returns ms).

    Disposal follows stb exactly (``stb_image.h:6729-6760``): a per-pixel
    ``history`` mask records which pixels the previous frame's raster
    covered; dispose 2 restores those pixels from the ``background``
    snapshot (the canvas as it stood *before* the previous frame drew,
    not transparent black), dispose 3 restores them from the composited
    frame two back (remapped to dispose 2 when none exists,
    ``stb_image.h:6733-6735``; the vendored copy's ``two_back`` pointer
    arithmetic is out-of-bounds UB — this implements the intent).  On
    the first frame, raster-untouched pixels get the global background
    color when ``bgindex > 0`` — including stb's channel quirk: the fill
    memcpy copies the palette's BGR-stored row verbatim into the RGBA
    canvas (``stb_image.h:6817-6824``).
    """
    frames: list[np.ndarray] = []
    delays: list[int] = []
    canvas = background = history = None
    prev_dispose = 0
    try:
        for w, h, (bgindex, gpal), fr in _gif_walk(data):
            x0, y0, idx, pal, transparent, delay_cs, dispose = fr
            if canvas is None:
                canvas = np.zeros((h, w, 4), np.uint8)
                background = np.zeros((h, w, 4), np.uint8)
            else:
                d = prev_dispose
                if d == 3 and len(frames) < 2:
                    d = 2  # no two-back frame to revert to
                if d == 3:
                    canvas = np.where(history[..., None], frames[-2], canvas)
                elif d == 2:
                    canvas = np.where(history[..., None], background, canvas)
                background = canvas.copy()
            ih, iw = idx.shape
            history = np.zeros((h, w), bool)
            history[y0 : y0 + ih, x0 : x0 + iw] = True
            region = canvas[y0 : y0 + ih, x0 : x0 + iw]
            rgba = np.concatenate(
                [pal[idx], np.full((ih, iw, 1), 255, np.uint8)], -1
            )
            if transparent is not None:
                keep = (idx == transparent)[..., None]
                rgba = np.where(keep, region, rgba)
            region[...] = rgba
            if not frames and bgindex > 0:  # first frame only
                fill = (
                    np.array([0, 0, 0, 255], np.uint8)
                    if gpal is None or bgindex >= len(gpal)
                    else np.concatenate([gpal[bgindex][::-1], [255]]).astype(
                        np.uint8
                    )
                )
                canvas[~history] = fill
            frames.append(canvas.copy())
            delays.append(delay_cs * 10)
            prev_dispose = dispose
    except (IndexError, struct.error) as e:
        raise FormatError(f"truncated GIF: {e}") from e
    if not frames:
        raise FormatError("GIF contains no image")
    return np.stack(frames), delays


def _gif_walk(data: bytes):
    """Yield ``(w, h, (bgindex, gpal),
    (x0, y0, idx, pal, transparent, delay_cs, dispose))`` per image block;
    the graphic-control state resets after each image per the 89a spec."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise FormatError("not a GIF")
    w, h = struct.unpack("<HH", data[6:10])
    check_dims(w, h)
    flags = data[10]
    bgindex = data[11]
    pos = 13
    gpal = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gpal = np.frombuffer(data[pos : pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    transparent = None
    delay_cs = 0
    dispose = 0
    while pos < len(data):
        b0 = data[pos]
        if b0 == 0x21:  # extension
            label = data[pos + 1]
            pos += 2
            if label == 0xF9:  # graphic control
                size = data[pos]
                gflags = data[pos + 1]
                delay_cs = struct.unpack("<H", data[pos + 2 : pos + 4])[0]
                dispose = (gflags >> 2) & 7
                transparent = data[pos + 4] if gflags & 1 else None
                pos += size + 1
            while data[pos] != 0:  # skip sub-blocks
                pos += data[pos] + 1
            pos += 1
        elif b0 == 0x2C:  # image descriptor
            x0, y0, iw, ih = struct.unpack("<HHHH", data[pos + 1 : pos + 9])
            iflags = data[pos + 9]
            pos += 10
            pal = gpal
            if iflags & 0x80:
                n = 2 << (iflags & 7)
                pal = np.frombuffer(
                    data[pos : pos + 3 * n], np.uint8
                ).reshape(n, 3)
                pos += 3 * n
            if pal is None:
                raise FormatError("GIF image without palette")
            min_code = data[pos]
            pos += 1
            chunks = []
            while data[pos] != 0:
                ln = data[pos]
                chunks.append(data[pos + 1 : pos + 1 + ln])
                pos += ln + 1
            pos += 1
            idx = _lzw_decode(b"".join(chunks), min_code, iw * ih).reshape(
                ih, iw
            )
            if iflags & 0x40:  # interlaced
                de = np.empty_like(idx)
                rows = np.concatenate(
                    [np.arange(0, ih, 8), np.arange(4, ih, 8),
                     np.arange(2, ih, 4), np.arange(1, ih, 2)]
                )
                de[rows] = idx
                idx = de
            yield w, h, (bgindex, gpal), (
                x0, y0, idx, pal, transparent, delay_cs, dispose,
            )
            transparent = None
            delay_cs = 0
            dispose = 0
        elif b0 == 0x3B:  # trailer
            break
        else:
            raise FormatError(f"bad GIF block 0x{b0:02X}")


# ------------------------------------------------------------- encoders
#
# The write half of the stb surface: the reference vendors
# stb_image_write.h (PNG/BMP/TGA/JPG/HDR) even though its testbench only
# calls stbi_write_png (full_TB.h:172,177).  PNG/JPEG encode live in
# their codec modules; the simple containers live here.


def _norm_img(img: np.ndarray) -> np.ndarray:
    """Normalize to (H, W, C) uint8, C in {1, 3, 4}."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise FormatError(f"expected uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise FormatError(f"expected (H, W, C<=4) image, got {img.shape}")
    return img


def encode_bmp(img: np.ndarray) -> bytes:
    """Windows BMP, bottom-up: BI_RGB 24-bit (gray/RGB), or 32-bit
    BITMAPV4 + BI_BITFIELDS alpha masks (RGBA — plain 32-bit BI_RGB
    alpha is ignored by most readers)."""
    img = _norm_img(img)
    h, w, c = img.shape
    if c == 1:
        img = np.repeat(img, 3, axis=2)
        c = 3
    nb = 4 if c == 4 else 3
    px = img[::-1, :, [2, 1, 0, 3][:nb]]  # RGB(A) -> BGR(A), bottom-up
    stride = (w * nb + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * nb] = px.reshape(h, w * nb)
    data = rows.tobytes()
    if nb == 3:
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(data),
                           2835, 2835, 0, 0)
    else:  # BITMAPV4HEADER with explicit channel masks
        info = struct.pack(
            "<IiiHHIIiiII" "IIII" "I36xIII",
            108, w, h, 1, 32, 3, len(data), 2835, 2835, 0, 0,
            0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000,
            0x73524742, 0, 0, 0,  # LCS 'sRGB'; endpoints/gamma unused
        )
    off = 14 + len(info)
    return (struct.pack("<2sIHHI", b"BM", off + len(data), 0, 0, off)
            + info + data)


def _tga_rle_row(row: np.ndarray) -> bytes:
    """One row of TGA RLE packets, byte-identical to stb's encoder
    (``stb_image_write.h:550-604``), including its raw-run scan that
    compares pixels two apart (``prev`` lags ``k`` by 2) and shrinks the
    raw packet by one when it trips.  Packets never cross rows and hold
    at most 128 pixels."""
    w = len(row)
    eq1 = np.zeros(w, bool)
    if w > 1:
        eq1[: w - 1] = (row[1:] == row[:-1]).all(axis=1)
    eq2 = np.zeros(w, bool)
    if w > 2:
        eq2[: w - 2] = (row[2:] == row[:-2]).all(axis=1)
    out = bytearray()
    i = 0
    while i < w:
        ln, diff = 1, True
        if i < w - 1:
            ln = 2
            diff = not eq1[i]
            k = i + 2
            if diff:
                while k < w and ln < 128:
                    if not eq2[k - 2]:
                        ln += 1
                        k += 1
                    else:
                        ln -= 1
                        break
            else:
                while k < w and ln < 128 and eq1[k - 1]:
                    ln += 1
                    k += 1
        if diff:
            out.append(ln - 1)
            out += row[i : i + ln].tobytes()
        else:
            out.append(128 + ln - 1)
            out += row[i].tobytes()
        i += ln
    return bytes(out)


def encode_tga(img: np.ndarray, rle: bool = True) -> bytes:
    """TGA, byte-identical to ``stbi_write_tga``: RLE by default
    (``stbi_write_tga_with_rle`` defaults to 1, ``stb_image_write.h:68``),
    type 11 (gray) / 10 (BGR/BGRA); ``rle=False`` gives the uncompressed
    type 3 / 2 variant.  Rows are written bottom-up with a bottom-left
    descriptor, as stb does (``vdir = -1``)."""
    img = _norm_img(img)
    h, w, c = img.shape
    if c == 1:
        imgtype, bpp, px = 3, 8, img[:, :, :1]
    else:
        imgtype, bpp = 2, c * 8
        px = img[:, :, [2, 1, 0, 3][:c]]  # RGB(A) -> BGR(A)
    desc = 8 if c == 4 else 0  # bottom-left origin; bits 0-3 = alpha depth
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, imgtype + (8 if rle else 0),
                      0, 0, 0, 0, 0, w, h, bpp, desc)
    px = np.ascontiguousarray(px)
    if not rle:
        return hdr + px[::-1].tobytes()
    return hdr + b"".join(_tga_rle_row(px[y]) for y in range(h - 1, -1, -1))


def encode_pnm(img: np.ndarray) -> bytes:
    """Binary PNM: P5 (gray) or P6 (RGB); alpha is not representable."""
    img = _norm_img(img)
    h, w, c = img.shape
    if c == 4:
        raise FormatError("PNM cannot carry an alpha channel")
    magic = b"P5" if c == 1 else b"P6"
    return magic + f"\n{w} {h}\n255\n".encode() + img.tobytes()


# ---------------------------------------------------------------- PSD
# Adobe Photoshop composite image (the slice stb_image.h decodes: 8/16-bit
# RGB-mode composites, raw or PackBits-RLE; layers/extra channels ignored).


def _packbits(src: memoryview, pos: int, out: np.ndarray) -> int:
    """Decode PackBits RLE into ``out`` (fills exactly len(out) bytes);
    returns the new source position."""
    n, need = 0, len(out)
    while n < need:
        c = src[pos]
        pos += 1
        if c == 128:  # no-op
            continue
        if c < 128:  # literal run of c+1 bytes
            cnt = c + 1
            if n + cnt > need:
                raise FormatError("PSD RLE overruns row")
            out[n : n + cnt] = np.frombuffer(src[pos : pos + cnt], np.uint8)
            pos += cnt
            n += cnt
        else:  # repeat next byte 257-c times
            cnt = 257 - c
            if n + cnt > need:
                raise FormatError("PSD RLE overruns row")
            out[n : n + cnt] = src[pos]
            pos += 1
            n += cnt
    return pos


def _u16_to_u8(v: np.ndarray) -> np.ndarray:
    # stb's 16→8 narrowing is the plain high byte (stbi__convert_16_to_8:
    # ``orig >> 8``) — same convention as the PNG path's depth-16 decode
    return (v >> 8).astype(np.uint8)


@_codec
def decode_psd16(data: bytes) -> np.ndarray:
    """PSD composite at full width → (H, W, 3|4) uint16 (stbi_load_16
    analog: native for 16-bit files, ``v * 257`` promotion for 8-bit)."""
    return decode_psd(data, _want16=True)


@_codec
def decode_psd(data: bytes, _want16: bool = False) -> np.ndarray:
    """Photoshop PSD composite → (H, W, 3|4) uint8.

    Supports what the reference's vendored stb does (stb_image.h psd
    path): version-1 files, RGB color mode (3), 8- or 16-bit channels,
    compression 0 (raw planar) or 1 (PackBits RLE, 8-bit only); only the
    flattened composite is read — layers and resources are skipped.
    """
    if data[:4] != b"8BPS":
        raise FormatError("not a PSD (missing 8BPS signature)")
    (version,) = struct.unpack(">H", data[4:6])
    if version != 1:
        raise FormatError(f"PSD version {version} unsupported")
    channels, h, w, depth, color_mode = struct.unpack(">HIIHH", data[12:26])
    check_dims(w, h)
    if channels < 1 or channels > 16:
        raise FormatError(f"PSD channel count {channels} out of range")
    if depth not in (8, 16):
        raise FormatError(f"PSD bit depth {depth} unsupported")
    if color_mode != 3:
        raise FormatError("PSD color mode must be RGB (3)")
    pos = 26
    for _ in range(3):  # color-mode data, image resources, layer/mask info
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        pos += 4 + ln
    (compression,) = struct.unpack(">H", data[pos : pos + 2])
    pos += 2
    out_c = 4 if channels >= 4 else 3
    planes = np.zeros((out_c, h * w), np.uint16 if _want16 else np.uint8)
    mv = memoryview(data)
    if compression == 0:
        nb = depth // 8
        for ch in range(channels):
            plane = data[pos : pos + h * w * nb]
            pos += h * w * nb
            if ch >= out_c:
                continue
            if depth == 8:
                v8 = np.frombuffer(plane, np.uint8)
                planes[ch] = v8.astype(np.uint16) * 257 if _want16 else v8
            else:
                v16 = np.frombuffer(plane, ">u2")
                planes[ch] = v16 if _want16 else _u16_to_u8(v16)
    elif compression == 1:
        if depth != 8:
            raise FormatError("PSD RLE is only defined for 8-bit channels")
        pos += 2 * h * channels  # per-row byte counts (redundant; skipped)
        row = np.empty(w, np.uint8)
        for ch in range(channels):
            for y in range(h):
                pos = _packbits(mv, pos, row)
                if ch < out_c:
                    planes[ch, y * w : (y + 1) * w] = (
                        row.astype(np.uint16) * 257 if _want16 else row
                    )
    else:
        raise FormatError(f"PSD compression {compression} unsupported")
    return np.ascontiguousarray(
        planes.reshape(out_c, h, w).transpose(1, 2, 0)
    )


# ---------------------------------------------------------------- HDR
# Radiance RGBE (.hdr / .pic-radiance): float RGB with a shared exponent
# byte.  stb_image.h decodes it to float (stbi_loadf) or tone-maps to LDR
# with gamma 2.2 / scale 1 (stbi_hdr_to_ldr_gamma/scale defaults);
# stb_image_write.h emits the RLE scanline form.  Both directions here.


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE → (..., 3) float32 (0 where the exponent is 0)."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(np.float32(1.0), e - (128 + 8)).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    return np.where((e == 0)[..., None], np.float32(0.0), rgb)


@_codec
def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance HDR → (H, W, 3) float32 linear radiance.

    Accepts the ``#?RADIANCE`` / ``#?RGBE`` header, the ``-Y h +X w``
    orientation (the only one stb reads), and flat, old-style-RLE, and
    new-style (per-component) RLE scanlines.
    """
    if data[:2] != b"#?":
        raise FormatError("not a Radiance HDR (missing #? signature)")
    pos = 0
    fmt_ok = False
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            if line != b"FORMAT=32-bit_rle_rgbe":
                raise FormatError(f"HDR format {line!r} unsupported")
            fmt_ok = True
        if line == b"":
            break
    if not fmt_ok:
        raise FormatError("HDR header lacks FORMAT=32-bit_rle_rgbe")
    nl = data.index(b"\n", pos)
    res_line = data[pos:nl]
    res = res_line.split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise FormatError(f"HDR orientation {res_line!r} unsupported")
    h, w = int(res[1]), int(res[3])
    check_dims(w, h)
    out = np.zeros((h, w, 4), np.uint8)
    mv = memoryview(data)
    row = np.empty((w, 4), np.uint8)
    for y in range(h):
        if not (8 <= w <= 32767) or mv[pos] != 2 or mv[pos + 1] != 2 or (
            (mv[pos + 2] << 8) | mv[pos + 3]
        ) != w:
            # flat RGBE records, with old-style (1,1,1,n) run markers.
            # Fast path first: a marker-free row is w contiguous records —
            # bulk-read it (the common case for flat writers; the scalar
            # walk below would cost h·w Python iterations)
            if pos + 4 * w <= len(data):
                block = np.frombuffer(
                    mv[pos : pos + 4 * w], np.uint8
                ).reshape(w, 4)
                if not (
                    (block[:, 0] == 1) & (block[:, 1] == 1)
                    & (block[:, 2] == 1)
                ).any():
                    out[y] = block
                    pos += 4 * w
                    continue
            x = 0
            shift = 0
            prev = None
            while x < w:
                px = mv[pos : pos + 4]
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    if prev is None:
                        raise FormatError("HDR old-style run before any pixel")
                    cnt = px[3] << shift
                    row[x : x + cnt] = prev
                    x += cnt
                    shift += 8
                else:
                    row[x] = np.frombuffer(px, np.uint8)
                    prev = row[x].copy()
                    x += 1
                    shift = 0
            out[y] = row
        else:
            pos += 4
            for c in range(4):  # per-component RLE
                x = 0
                while x < w:
                    cnt = mv[pos]
                    pos += 1
                    if cnt > 128:  # run
                        out[y, x : x + cnt - 128, c] = mv[pos]
                        pos += 1
                        x += cnt - 128
                    else:  # literal
                        out[y, x : x + cnt, c] = np.frombuffer(
                            mv[pos : pos + cnt], np.uint8
                        )
                        pos += cnt
                        x += cnt
    return _rgbe_to_float(out)


def hdr_to_ldr(img: np.ndarray, gamma: float = 2.2, scale: float = 1.0
               ) -> np.ndarray:
    """stb's HDR→LDR tone map: ``(scale·c)^(1/gamma)·255 + 0.5``, clamped."""
    v = np.power(np.maximum(img, 0.0) * scale, 1.0 / gamma) * 255.0 + 0.5
    return np.clip(v, 0.0, 255.0).astype(np.uint8)


def ldr_to_hdr(img: np.ndarray, gamma: float = 2.2, scale: float = 1.0
               ) -> np.ndarray:
    """stb's LDR→HDR lift: ``(c/255)^gamma · scale`` as float32."""
    return (np.power(img.astype(np.float32) / 255.0, gamma) * scale).astype(
        np.float32
    )


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(..., 3) float → (..., 4) uint8 RGBE (shared-exponent encode)."""
    maxc = img.max(axis=-1)
    m, e = np.frexp(maxc)
    # value = mantissa · 2^e; stored byte = c · (m·256/maxc), exponent e+128
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = np.where(maxc > 1e-32, m * 256.0 / maxc, 0.0)
    rgbe = np.empty(img.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(img * norm[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint8)
    return rgbe


def encode_hdr(img: np.ndarray) -> bytes:
    """(H, W, 3) float (or uint8, lifted via gamma 2.2) → Radiance HDR
    bytes, new-style per-component RLE scanlines (stb_image_write.h's
    layout)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.dtype == np.uint8:
        img = ldr_to_hdr(img)
    img = img.astype(np.float32)
    h, w, c = img.shape
    if c != 3:
        raise FormatError("HDR carries exactly 3 channels")
    head = b"#?RADIANCE\n# lanczos_tpu\nFORMAT=32-bit_rle_rgbe\n\n" + (
        f"-Y {h} +X {w}\n".encode()
    )
    rgbe = _float_to_rgbe(img)
    parts = [head]
    plain = not (8 <= w <= 32767)
    for y in range(h):
        if plain:
            parts.append(rgbe[y].tobytes())
            continue
        parts.append(bytes((2, 2, w >> 8, w & 0xFF)))
        for ch in range(4):
            _rle_component(rgbe[y, :, ch], parts)
    return b"".join(parts)


def _rle_component(comp: np.ndarray, parts: list) -> None:
    """Append new-style RLE packets for one scanline component.

    Run detection is vectorized (equal-neighbor boundaries → segment
    table); Python-level work is proportional to the number of RUNS plus
    w/128 literal packets, not to w (a 4K frame encoded in ~33M per-byte
    iterations before)."""
    w = comp.size
    bounds = np.flatnonzero(comp[1:] != comp[:-1]) + 1
    starts = np.concatenate(([0], bounds, [w]))
    seg_len = np.diff(starts)
    run_segs = np.flatnonzero(seg_len >= 4)

    def _literals(lo: int, hi: int) -> None:
        while lo < hi:
            n = min(128, hi - lo)
            parts.append(bytes((n,)))
            parts.append(comp[lo : lo + n].tobytes())
            lo += n

    x = 0
    for i in run_segs:
        s, e = int(starts[i]), int(starts[i + 1])
        _literals(x, s)
        val = int(comp[s])
        while s < e:
            n = min(127, e - s)
            parts.append(bytes((128 + n, val)))
            s += n
        x = e
    _literals(x, w)


# ---------------------------------------------------------------- PIC
# Softimage PIC (the reference's stb decodes it; vanishingly rare today
# but part of the ingest contract).  Big-endian header, per-row packet
# list with uncompressed / pure-RLE / mixed-RLE channel encodings.


@_codec
def decode_pic(data: bytes) -> np.ndarray:
    """Softimage PIC → (H, W, 3|4) uint8 (alpha when a packet carries it)."""
    if data[:4] != b"\x53\x80\xf6\x34" or data[88:92] != b"PICT":
        raise FormatError("not a Softimage PIC")
    w, h = struct.unpack(">HH", data[92:96])
    check_dims(w, h)
    # ratio f32 + fields u16 + pad u16 precede the packet list
    pos = 104
    packets = []
    while True:
        if len(packets) > 10:
            raise FormatError("PIC packet list too long")
        chained, size, ptype, mask = data[pos : pos + 4]
        pos += 4
        packets.append((size, ptype, mask))
        if not chained:
            break
    has_alpha = any(mask & 0x10 for _, _, mask in packets)
    img = np.zeros((h, w, 4), np.uint8)
    img[:, :, 3] = 255
    mv = memoryview(data)

    def mask_channels(mask):
        return [i for i, bit in enumerate((0x80, 0x40, 0x20, 0x10))
                if mask & bit]

    for y in range(h):
        for size, ptype, mask in packets:
            chans = mask_channels(mask)
            if ptype == 0:  # uncompressed
                n = len(chans)
                px = np.frombuffer(mv[pos : pos + w * n], np.uint8)
                pos += w * n
                img[y][:, chans] = px.reshape(w, n)
            elif ptype == 1:  # pure RLE: (count, value...) records
                x = 0
                while x < w:
                    cnt = min(mv[pos], w - x)
                    pos += 1
                    val = [mv[pos + i] for i in range(len(chans))]
                    pos += len(chans)
                    img[y, x : x + cnt][:, chans] = val
                    x += cnt
            elif ptype == 2:  # mixed RLE
                x = 0
                while x < w:
                    cnt = mv[pos]
                    pos += 1
                    if cnt >= 128:
                        if cnt == 128:
                            cnt = (mv[pos] << 8) | mv[pos + 1]
                            pos += 2
                        else:
                            cnt -= 127
                        val = [mv[pos + i] for i in range(len(chans))]
                        pos += len(chans)
                        img[y, x : x + cnt][:, chans] = val
                        x += cnt
                    else:  # cnt+1 literal pixels
                        cnt += 1
                        px = np.frombuffer(
                            mv[pos : pos + cnt * len(chans)], np.uint8
                        )
                        pos += cnt * len(chans)
                        img[y, x : x + cnt][:, chans] = (
                            px.reshape(cnt, len(chans))
                        )
                        x += cnt
            else:
                raise FormatError(f"PIC packet type {ptype} unsupported")
    return np.ascontiguousarray(img if has_alpha else img[:, :, :3])


# ------------------------------------------------------------ header probe
#
# The ``stbi_info`` analog: parse just enough header to report dimensions,
# channel count, and sample width without decoding pixel data
# (stb_image.h's stbi__*_info family).


@_codec
def probe(data: bytes):
    """Header-only probe for the formats this module owns.

    Returns ``(format, width, height, channels, bits)`` where *channels*
    and *bits* describe what the matching decoder would return (palette
    and BGR→RGB conversions applied).  Raises :class:`FormatError` when
    the magic matches no known container; PNG/JPEG live in their own
    modules and are dispatched by :func:`lanczos_torch.io.probe_image`.
    """
    if data[:2] == b"BM":
        w, h = struct.unpack("<ii", data[18:26])
        h = abs(h)
        check_dims(w, h)
        bpp = struct.unpack("<H", data[28:30])[0]
        if bpp not in (1, 4, 8, 16, 24, 32):
            raise FormatError(f"BMP bpp {bpp} unsupported")
        return ("bmp", w, h, 4 if bpp == 32 else 3, 8)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        w, h = struct.unpack("<HH", data[6:10])
        check_dims(w, h)
        # transparency (→ alpha channel) comes from the first image's GCE
        pos = 13
        if data[10] & 0x80:
            pos += 3 * (2 << (data[10] & 7))
        channels = 3
        while pos < len(data) and data[pos] == 0x21:
            if data[pos + 1] == 0xF9 and data[pos + 3] & 1:
                channels = 4
            pos += 2
            while data[pos] != 0:
                pos += data[pos] + 1
            pos += 1
        return ("gif", w, h, channels, 8)
    if data[:4] == b"8BPS":
        nch, h, w, depth, _mode = struct.unpack(">HIIHH", data[12:26])
        check_dims(w, h)
        return ("psd", w, h, 4 if nch >= 4 else 3, depth)
    if data[:2] == b"#?":
        pos = 0
        while True:
            nl = data.index(b"\n", pos)
            line = data[pos:nl]
            pos = nl + 1
            if line == b"":
                break
        res = data[pos : data.index(b"\n", pos)].split()
        if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
            raise FormatError("HDR orientation unsupported")
        check_dims(int(res[3]), int(res[1]))
        return ("hdr", int(res[3]), int(res[1]), 3, 32)
    if data[:4] == b"\x53\x80\xf6\x34" and data[88:92] == b"PICT":
        w, h = struct.unpack(">HH", data[92:96])
        check_dims(w, h)
        pos, has_alpha, npkt = 104, False, 0
        while True:
            npkt += 1
            if npkt > 10:  # same cap as decode_pic
                raise FormatError("PIC packet list too long")
            chained, _size, _ptype, mask = data[pos : pos + 4]
            pos += 4
            has_alpha = has_alpha or bool(mask & 0x10)
            if not chained:
                break
        return ("pic", w, h, 4 if has_alpha else 3, 8)
    if data[:2] in (b"P5", b"P6"):
        _, (w, h, maxval) = _pnm_header(data)
        check_dims(w, h)
        return ("pnm", w, h, 1 if data[:2] == b"P5" else 3, 8 if maxval < 256 else 16)
    raise FormatError("unrecognized image container")


@_codec
def probe_tga(data: bytes):
    """TGA header probe (no magic — plausibility-checked like stb's
    ``stbi__tga_test``).  Returns ``(width, height, channels, bits)``."""
    if len(data) < 18:
        raise FormatError("too short for a TGA header")
    cmap_type, img_type = data[1], data[2]
    if cmap_type not in (0, 1) or img_type not in (1, 2, 3, 9, 10, 11):
        raise FormatError("not a TGA")
    w, h = struct.unpack("<HH", data[12:16])
    bpp = data[16]
    if w == 0 or h == 0 or bpp not in (8, 15, 16, 24, 32):
        raise FormatError("not a TGA")
    if img_type in (3, 11):  # grayscale
        channels = 1
    elif img_type in (1, 9):  # paletted → RGB(A) by palette entry size
        channels = 4 if data[7] == 32 else 3
    else:
        channels = 4 if bpp == 32 else 3
    return (w, h, channels, 8)


# ---------------------------------------------------------------------------
# GIF encode (beyond stb: stb_image_write has no GIF writer).  Global
# median-cut palette + GIF89a container + LZW (native C++ bit-serial core
# with a behavior-identical Python fallback, the write twin of _lzw_decode).


def _lzw_encode(idx: np.ndarray, min_code_size: int) -> bytes:
    """GIF-flavored LZW encode of a flat uint8 index array.

    Emits CLEAR up front, widens codes with the encoder-side DELAYED bump
    (the decoder adds its k-th entry one code read later, so it widens one
    code later — the encoder widens once next_code exceeds the current
    range), and CLEAR+resets when the table fills at 4096 — so
    decode(encode(x)) is x by construction."""
    from lanczos_torch.io._native import native_lib

    n = int(idx.size)
    lib = native_lib()
    if lib is not None and hasattr(lib, "gif_lzw_encode"):
        src = np.ascontiguousarray(idx, np.uint8)
        out = np.empty(3 * n // 2 + 256, np.uint8)
        rc = lib.gif_lzw_encode(
            src.ctypes.data_as(lib.u8p), n, min_code_size,
            out.ctypes.data_as(lib.u8p), out.size,
        )
        if rc >= 0:
            return out[:rc].tobytes()
    clear = 1 << min_code_size
    eoi = clear + 1
    table = {}
    next_code = eoi + 1
    code_size = min_code_size + 1
    acc = nbits = 0
    parts = bytearray()

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += code_size
        while nbits >= 8:
            parts.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    it = iter(np.asarray(idx, np.uint8).ravel().tolist())
    prev = next(it, None)
    if prev is not None:
        for b in it:
            key = (prev, b)
            code = table.get(key)
            if code is not None:
                prev = code
                continue
            emit(prev)
            if next_code < 4096:
                table[key] = next_code
                next_code += 1
                # delayed bump: the decoder adds its k-th entry one code
                # read later than the encoder does, so it widens one code
                # later — widen only once next_code EXCEEDS the range
                if next_code == (1 << code_size) + 1 and code_size < 12:
                    code_size += 1
            else:
                emit(clear)
                table.clear()
                next_code = eoi + 1
                code_size = min_code_size + 1
            prev = b
        emit(prev)
    emit(eoi)
    if nbits:
        parts.append(acc & 0xFF)
    return bytes(parts)


def _gif_palette(frames: np.ndarray):
    """Global palette + per-frame index maps.

    ≤256 distinct colors → exact palette (lossless round-trip); more →
    median-cut over the distinct colors to 256, nearest-palette mapping."""
    keys = (
        frames[..., 0].astype(np.uint32) << 16
        | frames[..., 1].astype(np.uint32) << 8
        | frames[..., 2].astype(np.uint32)
    )
    uniq, inv = np.unique(keys, return_inverse=True)
    cols = np.stack(
        [uniq >> 16 & 255, uniq >> 8 & 255, uniq & 255], axis=1
    ).astype(np.uint8)
    if uniq.size <= 256:
        pal = cols
        u2p = np.arange(uniq.size)
    else:
        boxes = [np.arange(uniq.size)]
        while len(boxes) < 256:
            spans = [
                (np.ptp(cols[b], axis=0).max() if b.size > 1 else -1, i)
                for i, b in enumerate(boxes)
            ]
            span, bi = max(spans)
            if span <= 0:
                break  # every box is a single color already
            b = boxes.pop(bi)
            ch = int(np.argmax(np.ptp(cols[b], axis=0)))
            order = b[np.argsort(cols[b, ch], kind="stable")]
            boxes.insert(bi, order[: order.size // 2])
            boxes.insert(bi + 1, order[order.size // 2 :])
        pal = np.stack(
            [
                np.round(cols[b].mean(axis=0)).astype(np.uint8)
                for b in boxes
            ]
        )
        # nearest palette entry per distinct color (vectorized over the
        # ≤ |uniq| × 256 distance table, chunked to bound memory)
        u2p = np.empty(uniq.size, np.int64)
        p32 = pal.astype(np.int32)
        for lo in range(0, uniq.size, 65536):
            c = cols[lo : lo + 65536].astype(np.int32)
            d = ((c[:, None, :] - p32[None, :, :]) ** 2).sum(axis=2)
            u2p[lo : lo + 65536] = np.argmin(d, axis=1)
    index_frames = u2p[inv].reshape(keys.shape).astype(np.uint8)
    return pal, index_frames


def encode_gif(
    frames: np.ndarray,
    delays_cs=None,
    loop: int = 0,
) -> bytes:
    """Encode (H, W[, C]) or (T, H, W[, C]) uint8 frames as a GIF.

    Beyond-stb surface (stb_image_write has no GIF encoder): one global
    palette — exact when the clip has ≤256 distinct colors (lossless
    round-trip through :func:`decode_gif` / :func:`decode_gif_frames`),
    median-cut quantized otherwise.  Multi-frame input writes a GIF89a
    animation: ``delays_cs`` is the per-frame delay in centiseconds (an
    int, or a length-T sequence; default 10), ``loop`` the Netscape loop
    count (0 = forever).  Grayscale is replicated to RGB; RGBA is
    rejected (use 3 channels — GIF alpha is 1-bit color-key only).
    """
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None, :, :, None]
    elif frames.ndim == 3 and frames.shape[-1] in (1, 3):
        frames = frames[None]
    elif frames.ndim == 3 and frames.shape[-1] == 4:
        raise ValueError(
            "encode_gif takes 1 or 3 channels (GIF transparency is "
            "color-key only; composite alpha first).  For a (T, H, 4) "
            "grayscale stack pass (T, H, W, 1) explicitly."
        )
    elif frames.ndim == 3:  # (T, H, W) grayscale stack
        frames = frames[..., None]
    if frames.ndim != 4 or frames.dtype != np.uint8:
        raise ValueError("encode_gif wants uint8 (T?, H, W, 1|3) frames")
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    if frames.shape[-1] != 3:
        raise ValueError(
            f"encode_gif takes 1 or 3 channels, got {frames.shape[-1]} "
            "(GIF transparency is color-key only; composite alpha first)"
        )
    t, h, w = frames.shape[:3]
    check_dims(w, h)
    pal, idx = _gif_palette(frames)
    pbits = max(2, int(np.ceil(np.log2(max(pal.shape[0], 2)))))
    gct = np.zeros((1 << pbits, 3), np.uint8)
    gct[: pal.shape[0]] = pal

    if delays_cs is None:
        delays = [10] * t
    elif np.isscalar(delays_cs):
        delays = [int(delays_cs)] * t
    else:
        delays = [int(d) for d in delays_cs]
        if len(delays) != t:
            raise ValueError(f"{len(delays)} delays for {t} frames")

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack(
        "<HHBBB", w, h, 0x80 | (pbits - 1) << 4 | (pbits - 1), 0, 0
    )
    out += gct.tobytes()
    if t > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
        out += struct.pack("<H", loop) + b"\x00"
    for k in range(t):
        if t > 1:
            # graphic control: dispose=1 (keep), no transparency
            out += b"\x21\xf9\x04" + struct.pack(
                "<BHB", 1 << 2, delays[k], 0
            ) + b"\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        mcs = pbits
        out.append(mcs)
        data = _lzw_encode(idx[k].ravel(), mcs)
        for lo in range(0, len(data), 255):
            sub = data[lo : lo + 255]
            out.append(len(sub))
            out += sub
        out.append(0)
    out.append(0x3B)
    return bytes(out)
