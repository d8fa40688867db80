"""Image I/O of the port: from-scratch codecs (NumPy + zlib + native C++
hot loops) and the Y4M container, on the host.

The names of ``lanczos_tpu.io``, over copies of its modules (``png``,
``jpeg``, ``formats``, ``loader``, ``y4m`` and the native loops of
``_native``, built with ``g++`` at first use).  The functions below are the
original's word for word, apart from ``lanczos_tpu.io`` read as
``lanczos_torch.io`` and :func:`encode_image`'s GIF branch, which goes
through :func:`encode_gif`: the port's check of the 16-bit fields the copy
would otherwise fail to pack with a ``struct.error``.

:func:`read_image` sniffs the format from magic bytes (PNG/JPEG/BMP/GIF/
PSD/HDR/PIC/PNM, TGA by extension) — the FULL ``stbi_load`` format set.
:func:`write_image` is the ``stbi_write_*`` counterpart (PNG/JPEG/BMP/
TGA/HDR/PNM by extension, plus GIF).  :func:`probe_image` = ``stbi_info``,
:func:`decode_image_16` / :func:`read_image_16` = ``stbi_load_16``,
:func:`convert_channels` = ``desired_channels``, and
:func:`formats.decode_gif_frames` = ``stbi_load_gif``.  Everything here
takes and returns numpy arrays: decode on the host, move to the card with
``torch.from_numpy(...).cuda()``, and bring a result back with
``.cpu().numpy()`` before encoding it.
"""

from typing import NamedTuple

import numpy as np

from lanczos_torch.io.png import (  # noqa: F401
    PNGError,
    decode,
    encode,
    read_png,
    write_png,
)
from lanczos_torch.io.jpeg import JPEGError, decode as decode_jpeg  # noqa: F401
from lanczos_torch.io.y4m import (  # noqa: F401
    Y4MError,
    Y4MHeader,
    Y4MReader,
    Y4MWriter,
    parse_header,
    read_y4m,
    write_y4m,
)


def decode_image(data: bytes) -> np.ndarray:
    """Decode image bytes by magic sniffing → (H, W, C) uint8.

    Formats: PNG (incl. Adam7), JPEG (baseline + progressive, incl.
    CMYK/YCCK), BMP, GIF, PSD, PIC,
    Radiance HDR (tone-mapped to uint8 with stb's gamma-2.2 defaults —
    use :func:`lanczos_torch.io.formats.decode_hdr` for linear float32),
    and binary PNM.  (TGA has no magic — use :func:`read_image`, which
    falls back to it by file extension, or call ``formats.decode_tga``
    directly.)
    """
    from lanczos_torch.io import formats

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:2] == b"BM":
        return formats.decode_bmp(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return formats.decode_gif(data)
    if data[:4] == b"8BPS":
        return formats.decode_psd(data)
    if data[:2] == b"#?":
        return formats.hdr_to_ldr(formats.decode_hdr(data))
    if data[:4] == b"\x53\x80\xf6\x34" and data[88:92] == b"PICT":
        return formats.decode_pic(data)
    if data[:2] in (b"P5", b"P6"):
        return formats.decode_pnm(data)
    raise ValueError(
        "unrecognized image format (expect PNG/JPEG/BMP/GIF/PSD/HDR/PIC/"
        "PNM; TGA is dispatched by extension in read_image)"
    )


def decode_image_16(data: bytes) -> np.ndarray:
    """``stbi_load_16`` analog: decode to (H, W, C) uint16.

    Native 16-bit sources (PNG depth 16, PSD 16-bit, PNM maxval > 255)
    keep their full width; 8-bit sources are promoted ``v * 257`` exactly
    as stb's ``stbi__convert_8_to_16`` does.
    """
    from lanczos_torch.io import formats, png

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return png.decode16(data)
    if data[:4] == b"8BPS":
        return formats.decode_psd16(data)
    if data[:2] in (b"P5", b"P6"):
        return formats.decode_pnm16(data)
    return decode_image(data).astype(np.uint16) * 257


class ImageInfo(NamedTuple):
    """Header-probe result — the ``stbi_info`` + ``stbi_is_16_bit`` +
    ``stbi_is_hdr`` answers in one struct."""

    width: int
    height: int
    channels: int
    bits: int
    format: str

    @property
    def is_16bit(self) -> bool:
        return self.bits == 16

    @property
    def is_hdr(self) -> bool:
        return self.format == "hdr"


def probe_image(data: bytes, *, tga: bool = False) -> ImageInfo:
    """``stbi_info_from_memory`` analog: parse only the header.

    Returns :class:`ImageInfo` with the dimensions, the channel count the
    decoder would produce, the native sample width (8/16; 32 for HDR
    float), and the container name.  TGA has no magic, so it is only
    attempted when ``tga=True`` (``read_image``'s extension dispatch sets
    this) — stb does the same, trying TGA last and only by plausibility.
    """
    from lanczos_torch.io import formats, jpeg, png

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return ImageInfo(*png.probe(data), "png")
    if data[:2] == b"\xff\xd8":
        return ImageInfo(*jpeg.probe(data), "jpeg")
    try:
        fmt, w, h, c, bits = formats.probe(data)
        return ImageInfo(w, h, c, bits, fmt)
    except formats.FormatError:
        if tga:
            return ImageInfo(*formats.probe_tga(data), "tga")
        raise


def convert_channels(img: np.ndarray, channels: int) -> np.ndarray:
    """stb's ``desired_channels`` conversion (``stbi__convert_format``).

    Maps between C ∈ {1 grey, 2 grey+alpha, 3 RGB, 4 RGBA} with stb's
    exact integer luma ``y = (r*77 + g*150 + b*29) >> 8`` (uint16 inputs
    use the same weights at 16-bit width).  Returns the input unchanged
    when it already has ``channels``.
    """
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if c == channels:
        return img
    if c not in (1, 2, 3, 4) or channels not in (1, 2, 3, 4):
        raise ValueError(f"channel counts must be 1-4, got {c}->{channels}")
    dt = img.dtype
    full = np.array(65535 if dt == np.uint16 else 255, dt)
    if c <= 2:
        grey, alpha = img[..., :1], (img[..., 1:2] if c == 2 else None)
        rgb = np.repeat(grey, 3, axis=2)
    else:
        rgb, alpha = img[..., :3], (img[..., 3:4] if c == 4 else None)
    if channels <= 2:
        if c <= 2:
            out1 = grey
        else:
            wsum = (
                rgb[..., 0].astype(np.uint32) * 77
                + rgb[..., 1].astype(np.uint32) * 150
                + rgb[..., 2].astype(np.uint32) * 29
            )
            out1 = (wsum >> 8).astype(dt)[..., None]
        if channels == 1:
            return np.ascontiguousarray(out1)
        a = alpha if alpha is not None else np.full_like(out1, full)
        return np.concatenate([out1, a], axis=2)
    if channels == 3:
        return np.ascontiguousarray(rgb)
    a = alpha if alpha is not None else np.full_like(rgb[..., :1], full)
    return np.concatenate([rgb, a], axis=2)


def read_image(path, flip_vertical: bool = False) -> np.ndarray:
    """stbi_load equivalent: load an image file as (H, W, C) uint8.

    ``flip_vertical`` is the ``stbi_set_flip_vertically_on_load`` analog
    (bottom row first, the OpenGL texture convention) — an explicit
    argument instead of stb's process-global flag."""
    with open(path, "rb") as f:
        data = f.read()
    if str(path).lower().endswith((".tga", ".icb", ".vda", ".vst")):
        from lanczos_torch.io import formats

        img = formats.decode_tga(data)
    else:
        img = decode_image(data)
    return np.ascontiguousarray(img[::-1]) if flip_vertical else img


def read_image_16(path, flip_vertical: bool = False) -> np.ndarray:
    """``stbi_load_16`` file variant: (H, W, C) uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if str(path).lower().endswith((".tga", ".icb", ".vda", ".vst")):
        from lanczos_torch.io import formats

        img = formats.decode_tga(data).astype(np.uint16) * 257
    else:
        img = decode_image_16(data)
    return np.ascontiguousarray(img[::-1]) if flip_vertical else img


def encode_image(img: np.ndarray, format: str, **kw) -> bytes:
    """Encode to image bytes by format name (stbi_write_* analog).

    Formats: ``png`` (kw: ``compress_level``), ``jpeg``/``jpg`` (kw:
    ``quality``, ``subsample``), ``bmp``, ``tga``, ``hdr`` (takes float32
    linear radiance, or uint8 lifted via stb's gamma-2.2 convention),
    ``pnm``/``ppm``/``pgm`` — stb_image_write.h's full format set — plus
    ``gif`` (kw: ``delays_cs``, ``loop``; animated for (T, H, W, C)
    input), which stb_image_write lacks.
    """
    from lanczos_torch.io import formats, jpeg

    fmt = format.lower().lstrip(".")
    if fmt == "png":
        return encode(img, **kw)
    if fmt in ("jpg", "jpeg"):
        return jpeg.encode(img, **kw)
    if fmt == "bmp":
        return formats.encode_bmp(img)
    if fmt in ("tga", "icb", "vda", "vst"):
        return formats.encode_tga(img)
    if fmt == "gif":
        return encode_gif(img, **kw)
    if fmt == "hdr":
        return formats.encode_hdr(img)
    if fmt in ("pnm", "ppm", "pgm"):
        return formats.encode_pnm(img)
    raise ValueError(f"unsupported image write format {format!r}")


def write_image(path, img: np.ndarray, flip_vertical: bool = False, **kw) -> None:
    """stbi_write_* equivalent: save (H, W[, C]) uint8, format from the
    file extension (png/jpg/jpeg/bmp/tga/hdr/pnm/ppm/pgm).

    ``flip_vertical`` is the ``stbi_flip_vertically_on_write`` analog."""
    if flip_vertical:
        img = np.ascontiguousarray(np.asarray(img)[::-1])
    ext = str(path).rsplit(".", 1)[-1] if "." in str(path) else ""
    data = encode_image(img, ext, **kw)
    with open(path, "wb") as f:
        f.write(data)


_U16 = 65535


def encode_gif(frames: np.ndarray, delays_cs=None, loop: int = 0) -> bytes:
    """:func:`formats.encode_gif` after checking what GIF stores in 16-bit
    fields: the width and height (read from ``frames`` as the copy reads
    them) and, for an animation, every delay (centiseconds) and the loop
    count must lie in [0, 65535]; a ``ValueError`` names the limit instead
    of the copy's ``struct.error``."""
    from lanczos_torch.io import formats

    a = np.asarray(frames)
    if a.ndim == 2 or (a.ndim == 3 and a.shape[-1] in (1, 3, 4)):
        t, (h, w) = 1, a.shape[:2]
    elif a.ndim in (3, 4):
        t, h, w = a.shape[:3]
    else:
        t = h = w = 0  # the copy rejects the shape
    if h > _U16 or w > _U16:
        raise ValueError(f"a GIF frame is at most {_U16}x{_U16} pixels, got {w}x{h}")
    if t < 2:  # a still GIF stores no delay and no loop count
        return formats.encode_gif(frames, delays_cs=delays_cs, loop=loop)
    delays = [] if delays_cs is None else np.atleast_1d(np.asarray(delays_cs)).tolist()
    for name, v in [("delay", d) for d in delays] + [("loop count", loop)]:
        if not 0 <= int(v) <= _U16:
            raise ValueError(f"a GIF {name} is stored in 16 bits: 0..{_U16}, got {v}")
    return formats.encode_gif(frames, delays_cs=delays_cs, loop=loop)
