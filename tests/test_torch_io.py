"""The port's image codecs (``lanczos_torch.io``) against the originals
(``lanczos_tpu.io``) on the same bytes and arrays.

Limits: every decoder gives identical arrays (HDR: identical float32) and
every encoder identical bytes; a failure raises the same exception type
(by name) with the same message in both packages; the native loops and
the NumPy paths identical results; the copied files word for word the
originals apart from ``lanczos_tpu.io`` → ``lanczos_torch.io`` and the
module docstrings.  The three known faults of ``lanczos_tpu/io`` are not
fixed by any test here: ``encode_gif``'s 16-bit fields are checked in the
port's wrapper, and a ``(T, H, W)`` stack with W ∈ {1, 3} is not used.
"""

import ast
import io
import pathlib
import struct

import numpy as np
import pytest
from PIL import Image as PIL

torch = pytest.importorskip("torch")

import lanczos_tpu.io as tio  # noqa: E402
from lanczos_tpu.io import formats as tformats  # noqa: E402
from lanczos_tpu.io import jpeg as tjpeg  # noqa: E402

import lanczos_torch.io as pio  # noqa: E402
from lanczos_torch.io import _native, formats as pformats, jpeg as pjpeg, png as ppng  # noqa: E402

from test_torch_jax_codecs import reference_codecs  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def _rgb(rng, h, w, c=3, dtype=np.uint8):
    return rng.integers(0, 256 if dtype == np.uint8 else 65536, (h, w, c), dtype=dtype)


def _pil(arr, fmt, mode=None, convert=None, **kw):
    im = PIL.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr, mode=mode)
    if convert is not None:
        im = convert(im)
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _png16(arr16):
    from tests.test_io_api import _png16 as make

    return make(arr16)


def _animated_gif(frames, **kw):
    from tests.test_io_api import _animated_gif as make

    return make(frames, **kw)


def _psd(arr, depth=8):
    from tests.test_formats_ext import _psd_header

    h, w, c = arr.shape
    return _psd_header(c, h, w, depth) + struct.pack(">H", 0) + (
        arr.astype(">u2") if depth == 16 else arr).transpose(2, 0, 1).tobytes()


def _pic(arr):
    from tests.test_formats_ext import _pic_header

    h, w, _ = arr.shape
    return _pic_header(w, h, [(8, 0, 0xE0)]) + arr.tobytes()


def _corpus() -> dict:
    """name -> (bytes, tga): written by the JAX package's encoders where it
    has one, by PIL or by the JAX tests' helpers where it has none."""
    rng = np.random.default_rng(20)
    a = _rgb(rng, 19, 23)
    smooth = np.clip(np.add.outer(np.arange(24) * 9, np.arange(32) * 7), 0, 255).astype(np.uint8)
    smooth = np.stack([smooth, smooth[::-1], 255 - smooth], -1)
    out = {}
    for c in (1, 2, 3, 4):
        out[f"png_c{c}"] = tio.encode(_rgb(rng, 13, 17, c))
    out["png_16bit_rgb"] = _png16(_rgb(rng, 9, 11, 3, np.uint16))
    out["png_16bit_grey"] = _png16(_rgb(rng, 9, 11, 1, np.uint16))
    out["png_paletted"] = _pil(a, "PNG", convert=lambda im: im.quantize(16))
    out["png_adam7_rgb"] = _pil(_rgb(rng, 33, 17), "PNG", interlace=True)
    out["png_adam7_palette"] = _pil(a, "PNG", convert=lambda im: im.quantize(64),
                                    interlace=True)
    out["png_color_key"] = _pil(a, "PNG", transparency=tuple(int(v) for v in a[0, 0]))
    out["png_pil_filters"] = _pil(smooth, "PNG", optimize=True)
    out["jpeg_q90_444"] = tjpeg.encode(smooth, quality=90, subsample=False)
    out["jpeg_q75_420"] = tjpeg.encode(smooth, quality=75)
    out["jpeg_grey"] = tjpeg.encode(smooth[..., :1])
    out["jpeg_pil_422"] = _pil(smooth, "JPEG", quality=80, subsampling=1)
    out["jpeg_pil_restart"] = _pil(smooth, "JPEG", restart_marker_blocks=2)
    out["jpeg_progressive"] = _pil(smooth, "JPEG", progressive=True)
    out["jpeg_progressive_grey"] = _pil(smooth[..., :1], "JPEG", progressive=True)
    cmyk = np.concatenate([smooth, smooth[..., :1]], -1)
    out["jpeg_cmyk"] = _pil(cmyk, "JPEG", mode="CMYK")
    out["jpeg_cmyk_progressive"] = _pil(cmyk, "JPEG", mode="CMYK", progressive=True)
    out["bmp_24"] = tformats.encode_bmp(a)
    out["bmp_32_rgba"] = tformats.encode_bmp(_rgb(rng, 7, 9, 4))
    out["bmp_pil_palette"] = _pil(a, "BMP", convert=lambda im: im.quantize(16))
    out["bmp_pil_1bit"] = _pil(a, "BMP", convert=lambda im: im.convert("1"))
    out["tga_rle"] = tformats.encode_tga(a)
    out["tga_raw_rgba"] = tformats.encode_tga(_rgb(rng, 8, 6, 4), rle=False)
    out["pnm_p6"] = tformats.encode_pnm(a)
    out["pnm_p5"] = tformats.encode_pnm(a[..., :1])
    out["pnm_16bit"] = b"P6\n5 4\n65535\n" + _rgb(rng, 4, 5, 3, np.uint16).astype(">u2").tobytes()
    out["gif_still"] = tformats.encode_gif(a // 64 * 64)
    out["gif_animated"] = tformats.encode_gif(rng.integers(0, 8, (3, 10, 12, 3), np.uint8) * 32,
                                              delays_cs=[4, 5, 6], loop=2)
    out["gif_pil_animated"] = _animated_gif([_rgb(rng, 16, 20) for _ in range(3)],
                                            duration=[30, 40, 50], disposal=1)
    out["psd_8bit"] = _psd(a)
    out["psd_16bit"] = _psd(_rgb(rng, 6, 5, 3, np.uint16), 16)
    out["hdr_float"] = tformats.encode_hdr(rng.random((9, 13, 3), np.float32) * 4)
    out["hdr_from_uint8"] = tformats.encode_hdr(a)
    out["pic"] = _pic(a)
    return out


CORPUS = _corpus()
NAMES = sorted(CORPUS)


def _outcome(fn, *args, **kw):
    """The result of ``fn``, or the name and message of what it raised."""
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("raised", type(e).__name__, str(e))


def _same(got, want):
    if isinstance(want, tuple) and len(want) == 3 and isinstance(want[0], str):
        assert got == want  # ("raised", type name, message)
    elif isinstance(want, (tuple, list)):  # (frames, delays) or an ImageInfo
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ------------------------------------------------------------ decoders


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("name", NAMES)
def test_decoders_equal_the_originals(name):
    data = CORPUS[name]
    tga = name.startswith("tga")
    decode = "decode_tga" if tga else "decode_image"
    want = getattr(tio if not tga else tformats, decode)(data)
    _same(getattr(pio if not tga else pformats, decode)(data), want)
    _same(pio.probe_image(data, tga=tga), tio.probe_image(data, tga=tga))
    if not tga:
        _same(pio.decode_image_16(data), tio.decode_image_16(data))
    if name.startswith("gif"):
        _same(pformats.decode_gif_frames(data), tformats.decode_gif_frames(data))
    if name.startswith("hdr"):  # linear float32, not tone-mapped
        _same(pformats.decode_hdr(data), tformats.decode_hdr(data))


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("name", NAMES)
def test_corrupt_and_truncated_inputs_fail_alike(name):
    """The cuts and byte flips of ``tests/test_codec_robustness.py``: each
    gives the same array or the same exception type and message."""
    data = CORPUS[name]
    tga = name.startswith("tga")
    tdec = tformats.decode_tga if tga else tio.decode_image
    pdec = pformats.decode_tga if tga else pio.decode_image
    rng = np.random.default_rng(11)
    cases = [data[:cut] for cut in range(1, len(data), max(1, len(data) // 24))]
    for pos in list(range(min(24, len(data)))) + [int(p) for p in rng.integers(0, len(data), 24)]:
        mut = bytearray(data)
        mut[pos] ^= 0xFF
        cases.append(bytes(mut))
    for blob in cases:
        _same(_outcome(pdec, blob), _outcome(tdec, blob))
    for blob in cases[:12]:
        _same(_outcome(pio.probe_image, blob, tga=tga), _outcome(tio.probe_image, blob, tga=tga))


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("blob", [
    b"\x00\x01\x02\x03" * 30, b"P6\n99999999 99999999\n255\n" + bytes(20), b"P6\n0 5\n255\n",
    b"P5 1 1 255", b"P5 #x", b"#?RADIANCE\n\n-Y 2 +X 2\n", b"GIF89a", b"\xff\xd8\xff",
    b"\x89PNG\r\n\x1a\n" + bytes(30), b"8BPS" + bytes(30), b"BM" + bytes(60),
], ids=lambda b: repr(b[:6]))
def test_garbage_fails_alike(blob):
    for fn in ("decode_image", "decode_image_16", "probe_image"):
        _same(_outcome(getattr(pio, fn), blob), _outcome(getattr(tio, fn), blob))


@pytest.mark.usefixtures("reference_codecs")
def test_gif_bad_min_code_size_fails_alike():
    data = bytearray(CORPUS["gif_still"])
    pos = 13 + (3 * (2 << (data[10] & 7)) if data[10] & 0x80 else 0)
    assert data[pos] == 0x2C
    for bad in (0, 13, 24, 255):
        data[pos + 10] = bad
        _same(_outcome(pformats.decode_gif, bytes(data)),
              _outcome(tformats.decode_gif, bytes(data)))


# ------------------------------------------------------------ encoders


def _encoder_cases():
    rng = np.random.default_rng(21)
    a, g, rgba = _rgb(rng, 21, 18), _rgb(rng, 21, 18, 1), _rgb(rng, 9, 7, 4)
    return [
        ("png", a, {}), ("png", g[..., 0], {}), ("png", rgba, {"compress_level": 1}),
        ("png", _rgb(rng, 5, 6, 2), {"compress_level": 9}),
        ("jpg", a, {}), ("jpeg", a, {"quality": 40, "subsample": False}), ("jpg", g, {}),
        ("jpg", rgba, {"quality": 95}), ("bmp", a, {}), ("bmp", rgba, {}), ("bmp", g, {}),
        ("tga", a, {}), ("tga", rgba, {}), ("tga", g, {}), ("pnm", a, {}), ("pgm", g, {}),
        ("hdr", a, {}), ("hdr", rng.random((6, 5, 3), np.float32) * 9, {}),
        ("gif", a // 32 * 32, {}), ("gif", a, {}),
        ("gif", rng.integers(0, 4, (3, 8, 9, 3), np.uint8) * 80, {"delays_cs": [3, 4, 5]}),
        ("gif", rng.integers(0, 4, (2, 8, 9, 1), np.uint8) * 80, {"delays_cs": 7, "loop": 3}),
    ]


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("fmt,img,kw", _encoder_cases(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_encoders_write_the_originals_bytes(fmt, img, kw):
    assert pio.encode_image(img, fmt, **kw) == tio.encode_image(img, fmt, **kw)


def test_jpeg_encoder_options_equal():
    a = _rgb(np.random.default_rng(3), 16, 24)
    for q in (10, 50, 100):
        for sub in (True, False):
            assert pjpeg.encode(a, quality=q, subsample=sub) == tjpeg.encode(a, quality=q,
                                                                               subsample=sub)


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 5), np.uint8), np.zeros((0, 4, 3), np.uint8),
])
@pytest.mark.parametrize("fmt", ["png", "jpg", "bmp", "tga", "pnm", "gif", "xyz"])
def test_encoder_refusals_alike(fmt, bad):
    _same(_outcome(pio.encode_image, bad, fmt), _outcome(tio.encode_image, bad, fmt))


@pytest.mark.parametrize("frames,kw,limit", [
    (np.broadcast_to(np.uint8(0), (2, 65536, 3)), {}, "65535x65535"),
    (np.broadcast_to(np.uint8(0), (70000, 2, 3)), {}, "65535x65535"),
    (np.zeros((2, 4, 5, 3), np.uint8), {"delays_cs": [5, 70000]}, "delay"),
    (np.zeros((2, 4, 5, 3), np.uint8), {"delays_cs": -1}, "delay"),
    (np.zeros((2, 4, 5, 3), np.uint8), {"loop": 65536}, "loop count"),
])
def test_encode_gif_checks_its_16_bit_fields(frames, kw, limit):
    with pytest.raises(ValueError, match=limit):
        pio.encode_gif(frames, **kw)
    with pytest.raises(ValueError, match=limit):
        pio.encode_image(frames, "gif", **kw)


def test_encode_gif_within_limits_equals_the_copy():
    frames = np.random.default_rng(4).integers(0, 4, (3, 6, 7, 3), np.uint8) * 60
    for kw in ({}, {"delays_cs": 65535, "loop": 65535}, {"delays_cs": [0, 1, 2]}):
        assert pio.encode_gif(frames, **kw) == pformats.encode_gif(frames, **kw)
    # a still GIF stores neither field: the copy's behaviour stands
    assert pio.encode_gif(frames[0], loop=70000) == pformats.encode_gif(frames[0], loop=70000)


# ------------------------------------------------- channels, files, flips


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("src", [1, 2, 3, 4])
@pytest.mark.parametrize("dst", [1, 2, 3, 4])
def test_convert_channels_equal(src, dst, dtype):
    img = _rgb(np.random.default_rng(src * 10 + dst), 5, 6, src, dtype)
    _same(pio.convert_channels(img, dst), tio.convert_channels(img, dst))


def test_convert_channels_refusal_alike():
    img = np.zeros((3, 3, 5), np.uint8)
    _same(_outcome(pio.convert_channels, img, 3), _outcome(tio.convert_channels, img, 3))
    _same(_outcome(pio.convert_channels, img[..., :3], 7),
          _outcome(tio.convert_channels, img[..., :3], 7))


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("ext", ["png", "jpg", "bmp", "tga", "ppm", "pgm", "hdr", "gif"])
@pytest.mark.parametrize("flip", [False, True])
def test_files_equal(tmp_path, ext, flip):
    rng = np.random.default_rng(5)
    img = _rgb(rng, 12, 10, 1 if ext == "pgm" else 3)
    if ext == "gif":
        img = img // 64 * 64
    pio.write_image(tmp_path / f"p.{ext}", img, flip_vertical=flip)
    tio.write_image(tmp_path / f"t.{ext}", img, flip_vertical=flip)
    assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"t.{ext}").read_bytes()
    for fn in ("read_image", "read_image_16"):
        _same(getattr(pio, fn)(tmp_path / f"p.{ext}", flip_vertical=flip),
              getattr(tio, fn)(tmp_path / f"t.{ext}", flip_vertical=flip))


def test_names_of_the_original_are_all_there():
    want = {n for n in dir(tio) if not n.startswith("_") and n not in ("NamedTuple", "np")}
    assert want <= set(dir(pio)), want - set(dir(pio))
    assert pio.ImageInfo(1, 2, 3, 16, "hdr").is_16bit and pio.ImageInfo(1, 2, 3, 32, "hdr").is_hdr


# ------------------------------------------------ native and NumPy paths


def test_native_codecs_are_built_outside_the_sources():
    assert _native.native_paths() == {"png": True, "jpeg": True, "gif": True}
    here = REPO / "lanczos_torch" / "io" / "_native"
    assert not list(here.glob("*.so"))
    built = {p.name.split("_")[0] for p in (REPO / "lanczos_torch" / "_build").glob("lib*.so")}
    assert {"libpngfilter", "libjpegdec", "libgiflzw"} <= built


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("name", [n for n in NAMES if n.startswith(("png", "gif", "psd"))])
def test_numpy_path_equals_the_native_path(name, monkeypatch):
    """Decoding: the same arrays.  Encoding: the NumPy PNG filter picks
    among filters 0-2 where the native one tries all five, so the bytes
    differ; each path's bytes equal the original's on the same path, and
    decode to the same image."""
    data = CORPUS[name]
    img = pio.decode_image(data)
    native = img, pio.decode_image_16(data), pio.encode_image(img, "png"), pio.encode_image(
        img[..., :3], "gif")
    assert native[2] == tio.encode_image(img, "png")
    for mod in (ppng, _native, tio.png, tio._native):
        monkeypatch.setattr(mod, "native_lib", lambda: None)
    _same(pio.decode_image(data), native[0])
    _same(pio.decode_image_16(data), native[1])
    enc = pio.encode_image(img, "png")
    assert enc == tio.encode_image(img, "png")
    _same(pio.decode_image(enc), pio.decode_image(native[2]))
    assert pio.encode_image(img[..., :3], "gif") == native[3]


def test_jpeg_without_the_library_raises_as_the_original():
    data = CORPUS["jpeg_q75_420"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pjpeg, "native_lib", lambda: None)
        mp.setattr(tjpeg, "native_lib", lambda: None)
        _same(_outcome(pio.decode_image, data), _outcome(tio.decode_image, data))


# ------------------------------------------------------------- the copies


def _without_module_docstring(text: str) -> str:
    end = ast.parse(text).body[0].end_lineno
    return "".join(text.splitlines(keepends=True)[end:])


@pytest.mark.parametrize("name", ["formats.py", "png.py", "jpeg.py", "loader.py"])
def test_copies_are_the_originals_word_for_word(name):
    orig = (REPO / "lanczos_tpu" / "io" / name).read_text()
    copy = (REPO / "lanczos_torch" / "io" / name).read_text()
    want = _without_module_docstring(orig).replace("lanczos_tpu.io", "lanczos_torch.io")
    assert _without_module_docstring(copy) == want


@pytest.mark.parametrize("name", ["pngfilter.cpp", "jpegdec.cpp", "gif_lzw.cpp"])
def test_native_sources_are_the_originals(name):
    assert ((REPO / "lanczos_torch" / "io" / "_native" / name).read_bytes()
            == (REPO / "lanczos_tpu" / "io" / "_native" / name).read_bytes())


def test_init_functions_are_the_originals():
    """Every function and class of ``lanczos_tpu/io/__init__.py`` is in the
    port's word for word, ``encode_image``'s GIF branch (through the
    checking ``encode_gif``) the one line apart."""
    def defs(path):
        text = path.read_text()
        lines = text.splitlines(keepends=True)
        return {n.name: "".join(lines[n.lineno - 1:n.end_lineno])
                for n in ast.parse(text).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}

    orig = defs(REPO / "lanczos_tpu" / "io" / "__init__.py")
    copy = defs(REPO / "lanczos_torch" / "io" / "__init__.py")
    for name, text in orig.items():
        want = text.replace("lanczos_tpu.io", "lanczos_torch.io")
        if name == "encode_image":
            want = want.replace("return formats.encode_gif(img, **kw)",
                                "return encode_gif(img, **kw)")
        assert copy[name] == want, name
