"""Baseline and progressive JPEG decoder and baseline encoder (ITU T.81;
native C++ hot loop): the port's copy of ``lanczos_tpu/io/jpeg.py``.

Word for word the original below this docstring, apart from
``lanczos_tpu.io`` read as ``lanczos_torch.io``.

- Python parses the marker stream (DQT/DHT/SOF0/SOS/DRI) and derives the
  canonical Huffman tables;
- the per-MCU entropy decode + dequant + 8×8 IDCT runs in C++
  (``lanczos_torch/io/_native/jpegdec.cpp``) via ctypes; where the
  library cannot be built, decoding raises :class:`JPEGError`;
- chroma upsampling uses libjpeg-style triangle ("fancy") interpolation
  and the standard YCbCr→RGB conversion, vectorized in NumPy.

Scope: baseline DCT (SOF0/1, single interleaved scan) AND progressive
(SOF2, spectral selection + successive approximation, T.81 Annex G),
grayscale or YCbCr (any sampling factors incl. 4:2:0/4:2:2), CMYK/YCCK,
restart markers.  Arithmetic coding and lossless raise.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from lanczos_torch.io._native import native_lib


class JPEGError(ValueError):
    pass


def _codec(fn):
    from lanczos_torch.io.formats import codec_errors

    return codec_errors(JPEGError)(fn)


def _parse_dht(body: bytes, hc: np.ndarray, hv: np.ndarray) -> None:
    """Parse a DHT segment into the (8, 16)/(8, 256) table arrays
    (slots 0-3 DC, 4-7 AC)."""
    b = 0
    while b < len(body):
        tc, th = body[b] >> 4, body[b] & 15
        b += 1
        counts = np.frombuffer(body[b : b + 16], np.uint8)
        b += 16
        total = int(counts.sum())
        vals = np.frombuffer(body[b : b + total], np.uint8)
        b += total
        t = (0 if tc == 0 else 4) + th
        hc[t] = counts
        hv[t, :total] = vals


def _triangle_upsample_axis(p: np.ndarray, factor: int, axis: int, size: int):
    """libjpeg-style fancy upsampling along one axis (factor 1 or 2;
    other factors fall back to nearest)."""
    if factor == 1:
        return p
    p = np.moveaxis(p, axis, 0).astype(np.int32)
    if factor == 2:
        up = np.empty((p.shape[0] * 2,) + p.shape[1:], np.int32)
        prev = np.concatenate([p[:1], p[:-1]], axis=0)
        nxt = np.concatenate([p[1:], p[-1:]], axis=0)
        up[0::2] = (3 * p + prev + 2) >> 2
        up[1::2] = (3 * p + nxt + 1) >> 2
    else:
        up = np.repeat(p, factor, axis=0)
    up = up[:size]
    if up.shape[0] < size:  # pad by edge replication
        pad = np.broadcast_to(up[-1:], (size - up.shape[0],) + up.shape[1:])
        up = np.concatenate([up, pad], axis=0)
    return np.moveaxis(up, 0, axis)


@_codec
def probe(data: bytes):
    """Header-only probe (stbi_info analog) → ``(w, h, channels, bits)``.

    Walks the marker stream to the first SOFn (any DCT frame type,
    matching ``stbi__jpeg_info``)."""
    if data[:2] != b"\xff\xd8":
        raise JPEGError("not a JPEG (missing SOI)")
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF or marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2 if marker != 0xFF else 1
            continue
        (seglen,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            body = data[pos + 4 : pos + 2 + seglen]
            h, w = struct.unpack(">HH", body[1:5])
            # >= 3 components decode to RGB (CMYK/YCCK composite against
            # K), same clamp stb's info applies (img_n >= 3 ? 3 : 1)
            return (w, h, 3 if body[5] >= 3 else 1, 8)
        if marker == 0xD9:  # EOI before any frame header
            break
        pos += 2 + seglen
    raise JPEGError("no SOF marker found")


@_codec
def decode(data: bytes) -> np.ndarray:
    """JPEG bytes → (H, W, C) uint8 (C ∈ {1, 3})."""
    lib = native_lib()
    if lib is None or not hasattr(lib, "jpeg_decode_scan"):
        raise JPEGError("native jpeg decoder unavailable (no g++)")
    if data[:2] != b"\xff\xd8":
        raise JPEGError("not a JPEG (missing SOI)")

    quant = np.zeros((4, 64), np.int32)
    hc = np.zeros((8, 16), np.int32)  # 0-3 DC, 4-7 AC
    hv = np.zeros((8, 256), np.int32)
    frame = None
    progressive = False
    restart = 0
    transform = -1  # Adobe APP14 color transform (-1 = absent)
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:  # fill bytes before a marker (T.81 B.1.1.2)
            pos += 1
            continue
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (seglen,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        body = data[pos + 4 : pos + 2 + seglen]
        if marker == 0xDB:  # DQT
            b = 0
            while b < len(body):
                pq, tq = body[b] >> 4, body[b] & 15
                b += 1
                if pq == 0:
                    quant[tq] = np.frombuffer(body[b : b + 64], np.uint8)
                    b += 64
                else:
                    quant[tq] = np.frombuffer(
                        body[b : b + 128], ">u2"
                    ).astype(np.int32)
                    b += 128
        elif marker == 0xC4:  # DHT
            _parse_dht(body, hc, hv)
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1/2
            depth, h, w, nc = body[0], *struct.unpack(">HH", body[1:5]), body[5]
            if depth != 8:
                raise JPEGError(f"unsupported sample precision {depth}")
            if not (1 <= nc <= 4):
                raise JPEGError(f"component count {nc} out of range")
            comps = {}
            for i in range(nc):
                cid, hvb, tq = body[6 + 3 * i : 9 + 3 * i]
                ch, cv = hvb >> 4, hvb & 15
                if not (1 <= ch <= 4 and 1 <= cv <= 4 and tq <= 3):
                    raise JPEGError(
                        f"component {cid}: bad sampling/table ({ch},{cv},{tq})"
                    )
                comps[cid] = (ch, cv, tq)
            frame = (h, w, comps)
            progressive = marker == 0xC2
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise JPEGError(
                f"unsupported JPEG type (marker 0xFF{marker:02X}); "
                "baseline (SOF0/1) and progressive (SOF2) only"
            )
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe":  # APP14
            transform = body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JPEGError("SOS before SOF")
            if progressive:
                return _decode_progressive(
                    lib, data, pos, frame, quant, hc, hv, restart, transform
                )
            ns = body[0]
            if not (1 <= ns <= 4):
                raise JPEGError(f"scan component count {ns} out of range")
            scan = []
            for i in range(ns):
                cid, tt = body[1 + 2 * i], body[2 + 2 * i]
                if (tt >> 4) > 3 or (tt & 15) > 3:
                    raise JPEGError(f"bad huffman table selector {tt:#x}")
                scan.append((cid, tt >> 4, tt & 15))
            entropy_start = pos + 2 + seglen
            return _decode_scan(
                lib, data, entropy_start, frame, scan, quant, hc, hv,
                restart, transform
            )
        pos += 2 + seglen
    raise JPEGError("no SOS marker found")


def _next_marker(data: bytes, pos: int) -> int:
    """Index of the next real marker at/after ``pos`` (skipping entropy
    bytes, stuffed 0xFF00, and RST0-7, which belong to the scan).
    Vectorized — a Python byte walk here dominated progressive decode."""
    buf = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(buf[pos : len(buf) - 1] == 0xFF) + pos
    if ff.size:
        nxt = buf[ff + 1]
        real = (nxt != 0x00) & (nxt != 0xFF) & ~((nxt >= 0xD0) & (nxt <= 0xD7))
        hits = np.flatnonzero(real)
        if hits.size:
            return int(ff[hits[0]])
    return len(data)


def _decode_progressive(lib, data, pos, frame, quant, hc, hv, restart,
                        transform=-1):
    """SOF2: accumulate spectral-selection / successive-approximation scans
    into per-component coefficient grids (T.81 Annex G), then dequantize +
    IDCT once (``jpeg_finish_prog``).  ``pos`` points at the first SOS
    marker; DHT/DRI between scans are honored."""
    if lib is None or not hasattr(lib, "jpeg_decode_prog_scan"):
        raise JPEGError("native jpeg decoder unavailable (no g++)")
    h, w, comps = frame
    hmax = max(c[0] for c in comps.values())
    vmax = max(c[1] for c in comps.values())
    mcu_cols = -(-w // (8 * hmax))
    mcu_rows = -(-h // (8 * vmax))

    geom = {}
    coeff = {}
    for cid, (ch, cv, tq) in comps.items():
        gw, gh = mcu_cols * ch, mcu_rows * cv  # MCU-padded block grid
        comp_w = -(-w * ch // hmax)  # component's natural pixel dims
        comp_h = -(-h * cv // vmax)
        bw, bh = -(-comp_w // 8), -(-comp_h // 8)  # its true block dims
        geom[cid] = (gw, gh, bw, bh)
        coeff[cid] = np.zeros(gh * gw * 64, np.int32)

    n = len(data)
    saw_scan = False
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:  # fill bytes between segments (T.81 B.1.1.2)
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # standalone markers
            pos += 2
            continue
        (seglen,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        body = data[pos + 4 : pos + 2 + seglen]
        if marker == 0xD9:  # EOI
            break
        if marker == 0xC4:  # DHT between scans
            _parse_dht(body, hc, hv)
            pos += 2 + seglen
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
            pos += 2 + seglen
        elif marker == 0xDA:  # SOS
            ns = body[0]
            if not (1 <= ns <= 4):
                raise JPEGError(f"scan component count {ns} out of range")
            scomp = np.zeros((ns, 8), np.int32)
            ptrs = (lib.i32p * ns)()
            for i in range(ns):
                cid, tt = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in comps:
                    raise JPEGError(f"scan references unknown component {cid}")
                if (tt >> 4) > 3 or (tt & 15) > 3:
                    raise JPEGError(f"bad huffman table selector {tt:#x}")
                ch, cv, _tq = comps[cid]
                gw, _gh, bw, bh = geom[cid]
                scomp[i] = (ch, cv, tt >> 4, tt & 15, gw, bw, bh, 0)
                ptrs[i] = coeff[cid].ctypes.data_as(lib.i32p)
            ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
            ahal = body[3 + 2 * ns]
            if not (ss <= se <= 63 and (ahal >> 4) <= 13 and (ahal & 15) <= 13):
                raise JPEGError(
                    f"bad spectral/approximation range Ss={ss} Se={se} "
                    f"AhAl={ahal:#x}"
                )
            if ns > 1 and ss != 0:
                raise JPEGError("interleaved progressive AC scan is illegal")
            entropy_start = pos + 2 + seglen
            end = _next_marker(data, entropy_start)
            entropy = np.frombuffer(data[entropy_start:end], np.uint8)
            rc = lib.jpeg_decode_prog_scan(
                entropy.ctypes.data_as(lib.u8p), entropy.size, ns,
                np.ascontiguousarray(scomp).ctypes.data_as(lib.i32p),
                np.ascontiguousarray(hc).ctypes.data_as(lib.i32p),
                np.ascontiguousarray(hv).ctypes.data_as(lib.i32p),
                mcu_cols, mcu_rows, restart,
                int(ss), int(se), ahal >> 4, ahal & 15, ptrs,
            )
            if rc != 0:
                raise JPEGError(f"progressive scan decode failed (rc={rc})")
            saw_scan = True
            pos = end
        else:
            pos += 2 + seglen
    if not saw_scan:
        raise JPEGError("no SOS marker found")

    planes = []
    cids = list(comps.keys())
    for cid in cids:
        ch, cv, tq = comps[cid]
        gw, gh, bw, bh = geom[cid]
        plane = np.zeros((gh * 8, gw * 8), np.uint8)
        qt = np.ascontiguousarray(quant[tq])
        # only the component's true blocks (bw, bh) need IDCT; the MCU
        # padding beyond them is cropped by _assemble anyway
        rc = lib.jpeg_finish_prog(
            coeff[cid].ctypes.data_as(lib.i32p),
            qt.ctypes.data_as(lib.i32p),
            gw, bw, bh,
            plane.ctypes.data_as(lib.u8p), plane.shape[1],
        )
        if rc != 0:
            raise JPEGError(f"progressive finish failed (rc={rc})")
        planes.append(plane)
    return _assemble(planes, cids, comps, w, h, hmax, vmax, transform)


def _decode_scan(lib, data, start, frame, scan, quant, hc, hv, restart,
                 transform=-1):
    h, w, comps = frame
    ncomp = len(scan)
    hmax = max(c[0] for c in comps.values())
    vmax = max(c[1] for c in comps.values())
    mcu_cols = -(-w // (8 * hmax))
    mcu_rows = -(-h // (8 * vmax))

    comp_arr = np.zeros((ncomp, 5), np.int32)
    planes = []
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * ncomp)()
    strides = np.zeros(ncomp, np.int32)
    for i, (cid, dc_t, ac_t) in enumerate(scan):
        if cid not in comps:
            raise JPEGError(f"scan references unknown component {cid}")
        ch, cv, tq = comps[cid]
        comp_arr[i] = (ch, cv, tq, dc_t, ac_t)
        plane = np.zeros((mcu_rows * cv * 8, mcu_cols * ch * 8), np.uint8)
        planes.append(plane)
        ptrs[i] = plane.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        strides[i] = plane.shape[1]

    entropy = np.frombuffer(data[start:], np.uint8)
    rc = lib.jpeg_decode_scan(
        entropy.ctypes.data_as(lib.u8p),
        entropy.size,
        ncomp,
        np.ascontiguousarray(comp_arr).ctypes.data_as(lib.i32p),
        np.ascontiguousarray(hc).ctypes.data_as(lib.i32p),
        np.ascontiguousarray(hv).ctypes.data_as(lib.i32p),
        np.ascontiguousarray(quant).ctypes.data_as(lib.i32p),
        mcu_cols,
        mcu_rows,
        restart,
        ptrs,
        strides.ctypes.data_as(lib.i32p),
    )
    if rc != 0:
        raise JPEGError(f"entropy decode failed (rc={rc})")

    return _assemble(planes, [cid for cid, _, _ in scan], comps, w, h,
                     hmax, vmax, transform)


def _blinn(a, k):
    """stb's rounded 0-255 multiply (``stbi__blinn_8x8``), vectorized."""
    t = a.astype(np.uint32) * k.astype(np.uint32) + 128
    return ((t + (t >> 8)) >> 8).astype(np.uint8)


def _assemble(planes, cids, comps, w, h, hmax, vmax, transform=-1):
    """Crop planes to natural resolution, chroma-upsample, color-convert.

    ``transform`` is the Adobe APP14 color-transform tag: with four
    components 0 = CMYK (already Adobe-inverted) and 2 = YCCK, exactly as
    stb converts them (``stbi__blinn_8x8`` composite against K); any other
    value treats the 4th component as ignorable (stb's fallback).  Three
    components with ids R,G,B skip the YCbCr conversion."""
    full = []
    for i, cid in enumerate(cids):
        ch, cv, _ = comps[cid]
        cw = -(-w * ch // hmax)
        chh = -(-h * cv // vmax)
        p = planes[i][:chh, :cw]
        p = _triangle_upsample_axis(p, hmax // ch, 1, w)
        p = _triangle_upsample_axis(p, vmax // cv, 0, h)
        full.append(p.astype(np.int32))

    ncomp = len(cids)
    if ncomp == 1:
        return full[0].astype(np.uint8)[:, :, None]

    def ycbcr_to_rgb(y, cb, cr):
        y, cb, cr = (f.astype(np.float64) for f in (y, cb, cr))
        cb = cb - 128.0
        cr = cr - 128.0
        r = y + 1.402 * cr
        g = y - 0.344136286 * cb - 0.714136286 * cr
        b = y + 1.772 * cb
        rgb = np.stack([r, g, b], axis=-1)
        return np.clip(np.round(rgb), 0, 255).astype(np.uint8)

    if ncomp == 3:
        if cids == [0x52, 0x47, 0x42]:  # component ids 'R','G','B'
            return np.stack(full, axis=-1).astype(np.uint8)
        return ycbcr_to_rgb(*full)
    if ncomp == 4:
        k = full[3].astype(np.uint8)
        if transform == 0:  # CMYK, stored Adobe-inverted
            return np.stack(
                [_blinn(full[i].astype(np.uint8), k) for i in range(3)], -1
            )
        if transform == 2:  # YCCK
            rgb = ycbcr_to_rgb(*full[:3])
            return np.stack(
                [_blinn(255 - rgb[..., i], k) for i in range(3)], -1
            )
        return ycbcr_to_rgb(*full[:3])  # YCbCr + ignorable 4th (stb)
    raise JPEGError(f"unsupported component count {ncomp}")


# ------------------------------------------------------------- encoder
#
# Baseline (SOF0) JPEG encoder — the write half of the stb surface
# (stb_image_write.h's stbi_write_jpg).  Annex-K quantization tables with
# libjpeg quality scaling, Annex-K Huffman tables, 4:2:0 chroma for RGB
# (4:4:4 optional), grayscale single-component.  DCT + quantization are
# vectorized NumPy; the entropy pass loops only over nonzero coefficients.

_ZZ = np.array(
    [r * 8 + (d - r)
     for d in range(15)
     for r in (range(max(0, d - 7), min(d, 7) + 1) if d % 2
               else reversed(range(max(0, d - 7), min(d, 7) + 1)))],
    np.int64,
)

_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)

_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], np.int64)

# Annex K Huffman specs: (BITS counts per code length 1..16, HUFFVAL)
_HUFF_DC_L = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
              list(range(12)))
_HUFF_DC_C = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_HUFF_AC_L = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
     0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
     0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
     0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
     0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
     0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
     0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
     0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
     0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
     0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
     0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
     0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
     0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
     0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
     0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
     0xF9, 0xFA],
)
_HUFF_AC_C = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
     0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
     0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
     0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
     0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
     0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
     0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
     0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
     0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
     0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
     0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
     0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
     0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
     0xF9, 0xFA],
)

_DCT = None  # lazy orthonormal DCT-II matrix (== T.81 FDCT scaling)


def _dct_matrix() -> np.ndarray:
    global _DCT
    if _DCT is None:
        n = np.arange(8)
        m = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
        m *= np.sqrt(2.0 / 8.0)
        m[0] = np.sqrt(1.0 / 8.0)
        _DCT = m
    return _DCT


def _huff_codes(spec) -> dict:
    counts, vals = spec
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)  # T.81 byte stuffing
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put(0x7F, 8 - self.n)  # pad with 1-bits


def _quantized_blocks(plane: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """(H, W) uint8 plane (H, W multiples of 8) -> (bh, bw, 64) int32
    zigzagged quantized DCT coefficients."""
    h, w = plane.shape
    bh, bw = h // 8, w // 8
    blocks = (plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
              .astype(np.float64) - 128.0)
    d = _dct_matrix()
    coef = np.einsum("ij,bcjk,lk->bcil", d, blocks, d, optimize=True)
    q = np.round(coef.reshape(bh, bw, 64) / qtab.astype(np.float64))
    return q.astype(np.int32)[:, :, _ZZ]


def _pad_to(plane: np.ndarray, mh: int, mw: int) -> np.ndarray:
    h, w = plane.shape
    ph, pw = -h % mh, -w % mw
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return plane


def _encode_block(bw: _BitWriter, z, prev_dc: int, dc, ac) -> int:
    zl = z.tolist()
    diff = zl[0] - prev_dc
    s = abs(diff).bit_length()
    bw.put(*dc[s])
    if s:
        bw.put(diff if diff > 0 else diff + (1 << s) - 1, s)
    prev = 0
    for k in np.nonzero(z[1:])[0] + 1:
        run = int(k) - prev - 1
        while run >= 16:
            bw.put(*ac[0xF0])  # ZRL
            run -= 16
        v = zl[k]
        s = abs(v).bit_length()
        bw.put(*ac[(run << 4) | s])
        bw.put(v if v > 0 else v + (1 << s) - 1, s)
        prev = int(k)
    if prev != 63:
        bw.put(*ac[0x00])  # EOB
    return zl[0]


def _dht_segment(tc: int, th: int, spec) -> bytes:
    counts, vals = spec
    body = bytes([tc << 4 | th]) + bytes(counts) + bytes(vals)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


def encode(img: np.ndarray, quality: int = 90,
           subsample: bool | None = None) -> bytes:
    """(H, W[, C]) uint8 -> baseline JFIF bytes (stbi_write_jpg analog).

    C in {1, 3, 4}; alpha is dropped (JFIF cannot carry it).  ``quality``
    is the libjpeg 1-100 scale.  ``subsample`` picks 4:2:0 chroma; the
    default (None) follows stb/libjpeg practice: 4:2:0 below quality 90,
    4:4:4 at 90+.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise JPEGError(f"expected uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise JPEGError(f"expected (H, W, C<=4) image, got {img.shape}")
    if img.shape[2] == 4:
        img = img[:, :, :3]
    h, w, nc = img.shape
    if not (h and w):
        raise JPEGError("empty image")

    quality = min(100, max(1, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    ql = np.clip((_Q_LUMA * scale + 50) // 100, 1, 255)
    qc = np.clip((_Q_CHROMA * scale + 50) // 100, 1, 255)
    if subsample is None:
        subsample = quality < 90

    if nc == 1:
        planes = [img[:, :, 0]]
    else:
        rgb = img.astype(np.float64)
        y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        cb = 128.0 - 0.168735892 * rgb[..., 0] - 0.331264108 * rgb[..., 1] \
            + 0.5 * rgb[..., 2]
        cr = 128.0 + 0.5 * rgb[..., 0] - 0.418687589 * rgb[..., 1] \
            - 0.081312411 * rgb[..., 2]
        planes = [np.clip(np.round(p), 0, 255).astype(np.uint8)
                  for p in (y, cb, cr)]

    gray = nc == 1
    sub = 2 if (not gray and subsample) else 1
    if sub == 2:  # box-average 2x2 after padding to even dims
        for i in (1, 2):
            p = _pad_to(planes[i], 2, 2).astype(np.uint16)
            planes[i] = ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                          + p[1::2, 1::2] + 2) >> 2).astype(np.uint8)

    samp = [(sub, sub)] + ([] if gray else [(1, 1), (1, 1)])
    # luma pads to the full MCU grid (8·sub); chroma planes to 8
    zz = [_quantized_blocks(_pad_to(p, 8 * (samp[i][1] if i == 0 else 1),
                                    8 * (samp[i][0] if i == 0 else 1)),
                            ql if i == 0 else qc)
          for i, p in enumerate(planes)]

    # ---- headers
    out = bytearray(b"\xff\xd8")
    out += (b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00"
            + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + bytes([0, 0]))
    out += (b"\xff\xdb" + struct.pack(">H", 67) + bytes([0])
            + bytes(ql[_ZZ].astype(np.uint8)))
    if not gray:
        out += (b"\xff\xdb" + struct.pack(">H", 67) + bytes([1])
                + bytes(qc[_ZZ].astype(np.uint8)))
    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, h, w, ncomp)
    for i in range(ncomp):
        hs, vs = samp[i]
        sof += bytes([i + 1, hs << 4 | vs, 0 if i == 0 else 1])
    out += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    out += _dht_segment(0, 0, _HUFF_DC_L) + _dht_segment(1, 0, _HUFF_AC_L)
    if not gray:
        out += _dht_segment(0, 1, _HUFF_DC_C) + _dht_segment(1, 1, _HUFF_AC_C)
    sos = bytes([ncomp])
    for i in range(ncomp):
        sos += bytes([i + 1, 0 if i == 0 else 0x11])
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos

    # ---- entropy-coded scan, MCU-interleaved
    dc_l, ac_l = _huff_codes(_HUFF_DC_L), _huff_codes(_HUFF_AC_L)
    dc_c, ac_c = _huff_codes(_HUFF_DC_C), _huff_codes(_HUFF_AC_C)
    bw = _BitWriter()
    mcu_rows, mcu_cols = -(-h // (8 * sub)), -(-w // (8 * sub))
    prev = [0, 0, 0]
    for mr in range(mcu_rows):
        for mc in range(mcu_cols):
            for br in range(sub):
                for bc in range(sub):
                    prev[0] = _encode_block(
                        bw, zz[0][mr * sub + br, mc * sub + bc],
                        prev[0], dc_l, ac_l)
            for i in (1, 2) if not gray else ():
                prev[i] = _encode_block(bw, zz[i][mr, mc], prev[i],
                                        dc_c, ac_c)
    bw.flush()
    return bytes(out) + bytes(bw.out) + b"\xff\xd9"
