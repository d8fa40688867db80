"""The port's slice as a whole: ``lanczos_torch.upscale`` / ``Upscaler`` on
the CPU (the kernel's plain PyTorch version) against ``lanczos_tpu``, its
error paths, and an import with JAX absent.

Limits (``hwcert.py``'s contract): fp32 ≤ 1 LSB on ≤ 1% of pixels, bf16
≤ 3 LSB on ≤ 50% of pixels, each against the JAX package's fp32 result.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.models.upscaler import _cached_upscaler  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}
REPO = Path(__file__).resolve().parent.parent


def _within(got, want, precision):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    lim, frac_lim = LIMITS[precision]
    assert d.max() <= lim and (d > 0).mean() <= frac_lim, (d.max(), (d > 0).mean())


def _img(shape, seed):
    """Gradients plus noise, like the JAX tests' ``small_img``."""
    rng = np.random.default_rng(seed)
    h, w = shape[-3], shape[-2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (yy + xx) * 255 // max(h + w - 2, 1)], axis=-1)
    noise = rng.integers(-40, 40, size=tuple(shape[:-1]) + (3,))
    return np.clip(base + noise, 0, 255).astype(np.uint8)[..., : shape[-1]]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("scale,kw", [
    ((2, 1), {}),
    ((3, 2), {}),
    ((2, 1), {"align": "center", "edge_mode": "reflect"}),
])
def test_upscale_batched_matches_tpu(scale, kw, precision):
    img = _img((2, 36, 60, 3), seed=3)
    got = lanczos_torch.upscale(
        torch.from_numpy(img), scale=scale, a=3, precision=precision, **kw
    )
    assert got.device.type == "cpu"
    want = np.asarray(lanczos_tpu.upscale(img, scale=scale, a=3, **kw))
    _within(got.numpy(), want, precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_planar_matches_tpu(precision):
    img = _img((2, 30, 50, 3), seed=4)
    planar = np.ascontiguousarray(np.transpose(img, (0, 3, 1, 2)))
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", (30, 50), scale=(2, 1), a=3, precision=precision
    )
    got = lanczos_torch.Upscaler(cfg, device="cpu").planar(torch.from_numpy(planar))
    tpu_cfg = lanczos_tpu.ResampleConfig.from_profile(
        "precise", (30, 50), scale=(2, 1), a=3
    )
    want = np.asarray(lanczos_tpu.Upscaler(tpu_cfg).planar(planar))
    _within(got.numpy(), want, precision)
    # (C, H, W) and the interleaved call agree with the batched planar call
    one = lanczos_torch.Upscaler(cfg, device="cpu").planar(torch.from_numpy(planar[1]))
    assert torch.equal(one, got[1])
    inter = lanczos_torch.Upscaler(cfg, device="cpu")(torch.from_numpy(img))
    assert torch.equal(inter.permute(0, 3, 1, 2), got)


def test_grayscale_and_numpy_on_cpu():
    img = _img((24, 40, 3), seed=5)[..., 0]
    got = lanczos_torch.upscale(img, scale=(2, 1), device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (48, 80)
    want = np.asarray(lanczos_tpu.upscale(img, scale=(2, 1)))
    _within(got.numpy(), want, "fp32")


def test_upscaler_cache_reuses_and_evicts():
    _cached_upscaler.cache_clear()
    img = torch.from_numpy(_img((16, 24, 3), seed=6))
    lanczos_torch.upscale(img, scale=(2, 1))
    lanczos_torch.upscale(img, scale=(2, 1))
    info = _cached_upscaler.cache_info()
    assert (info.hits, info.misses, info.currsize) == (1, 1, 1)
    assert info.currbytes > 0
    old = _cached_upscaler.max_bytes
    try:
        _cached_upscaler.max_bytes = 1  # every entry exceeds it: keep the newest
        lanczos_torch.upscale(img, scale=(3, 1))
        assert _cached_upscaler.cache_info().currsize == 1
    finally:
        _cached_upscaler.max_bytes = old
        _cached_upscaler.cache_clear()


def test_dimension_mismatch_raises():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    up = lanczos_torch.Upscaler(cfg, device="cpu")
    with pytest.raises(ValueError, match="spatial dims"):
        up(torch.zeros((16, 25, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="spatial dims"):
        up.planar(torch.zeros((3, 17, 24), dtype=torch.uint8))


@pytest.mark.parametrize("make,path", [
    (lambda: lanczos_torch.ResampleConfig.from_profile(
        "hls", (16, 24), scale=(2, 1), a=2), "hls"),
    (lambda: lanczos_torch.ResampleConfig.from_profile(
        "c_oracle", (16, 24), scale=(2, 1)), "c_exact"),
    # nonlinear and linear configs without a fused plan that v2 does not
    # take either: auto falls through to the JAX package's chain
    (lambda: lanczos_torch.ResampleConfig(
        (4096, 4096), (64, 64), dering=True), "shift_xla"),
    (lambda: lanczos_torch.ResampleConfig(
        (4096, 4096), (64, 64), intermediate_quantize=True), "block"),
    (lambda: lanczos_torch.ResampleConfig((4096, 4096), (64, 64)), "shift_xla"),
])
def test_unported_configs_raise(make, path):
    """Configs the port once refused now run: each routes where the JAX
    package's ``auto`` routes it off its kernels."""
    cfg = make()
    up = lanczos_torch.Upscaler(cfg, device="cpu")
    assert up.path == path
    tpu = lanczos_tpu.Upscaler(lanczos_tpu.ResampleConfig(**{
        f: getattr(getattr(cfg, f), "value", getattr(cfg, f))
        for f in cfg.__dataclass_fields__
    }))
    assert up.backend == tpu.backend
    if cfg.in_shape == (4096, 4096):  # runs, one plane, against the gather path
        img = torch.from_numpy(
            np.random.default_rng(9).integers(0, 256, (4096, 4096, 1), dtype=np.uint8))
        want = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(img)
        _within(up(img).numpy(), want.numpy(), "fp32")


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
def test_non_uint8_input_raises(dtype):
    """uint16 and float input on the kernels' config take the JAX
    ``_float_fallback_fn`` (the strided path here): float → float32,
    uint16 → uint16, interleaved and planar."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    up = lanczos_torch.Upscaler(cfg, device="cpu")
    assert up.backend == "cuda"
    rng = np.random.default_rng(8)
    if dtype == torch.uint16:
        img = rng.integers(0, 65536, (16, 24, 3), dtype=np.uint16)
    else:
        img = rng.random((16, 24, 3), dtype=np.float32) * 255
    got = up(torch.from_numpy(img))
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="pallas")(img))
    assert got.dtype == dtype and want.dtype == img.dtype
    _close(got.numpy(), want)
    planar = up.planar(torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))))
    assert torch.equal(planar, got.permute(2, 0, 1))


def _close(got, want):
    """float: |Δ| ≤ 1e-3; integer: ≤ 1 LSB on ≤ 1% of pixels."""
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        return
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out", [
    ((288, 480), (18, 30)),  # 1/16 thumbnail: no fused plan, v1 in both packages
    ((24, 40), (36, 60)),  # 3/2: the port's fused plan; the JAX CPU run takes v1
    ((48, 40), (48, 60)),  # 1/1 by 3/2
])
def test_pallas_backend_matches_tpu_pallas(shape, out, precision):
    """``upscale(..., backend="pallas")`` against the JAX package's
    ``Upscaler(cfg, backend="pallas")`` (fp32, its Pallas kernels in
    interpret mode) on the same seeded image."""
    img = _img((2,) + shape + (3,), seed=7)
    got = lanczos_torch.upscale(torch.from_numpy(img), out_shape=out, a=3,
                                precision=precision, backend="pallas")
    tpu_cfg = lanczos_tpu.ResampleConfig.from_profile("precise", shape, out_shape=out, a=3)
    want = np.asarray(lanczos_tpu.Upscaler(tpu_cfg, backend="pallas")(img))
    _within(got.numpy(), want, precision)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
def test_pallas_backend_refuses_non_uint8(dtype):
    """Non-uint8 input on ``backend="pallas"`` takes the float fallback as
    the JAX package's does: block here (1/16 of 288×480 is strided-eligible,
    so use a rational 3/2 of an odd height)."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (27, 40), out_shape=(40, 60))
    up = lanczos_torch.Upscaler(cfg, backend="pallas", device="cpu")
    rng = np.random.default_rng(10)
    if dtype == torch.uint16:
        img = rng.integers(0, 65536, (27, 40, 3), dtype=np.uint16)
    else:
        img = rng.random((27, 40, 3), dtype=np.float32) * 255
    got = up(torch.from_numpy(img))
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", (27, 40), out_shape=(40, 60))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="pallas")(img))
    assert got.dtype == dtype
    _close(got.numpy(), want)


def test_unported_backend_raises():
    """``backend="xla"`` (once refused) runs the gather path; an unknown
    name raises."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    up = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")
    assert up.path == "xla"
    img = _img((16, 24, 3), seed=11)
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="xla")(img))
    _within(up(torch.from_numpy(img)).numpy(), want, "fp32")
    with pytest.raises(ValueError, match="unknown backend"):
        lanczos_torch.Upscaler(cfg, backend="mxu", device="cpu")
    with pytest.raises(TypeError, match="Mesh"):  # mesh= takes a lanczos_torch Mesh
        lanczos_torch.upscale(torch.from_numpy(img), scale=(2, 1), mesh=object())


def test_numpy_input_needs_cuda_by_default(monkeypatch):
    """A numpy array goes to ``device="cuda"`` unless told otherwise; with
    no CUDA device that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((16, 24, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lanczos_torch.upscale(img, scale=(2, 1))
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lanczos_torch.Upscaler(cfg).planar(np.zeros((3, 16, 24), np.uint8))


def test_fused_ops_refuses_bad_shape_and_device():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    ops = rc.FusedOps(cfg, "cpu")
    with pytest.raises(ValueError, match="expected"):
        rc.fused_call(ops, torch.zeros((3, 16, 25), dtype=torch.uint8))
    with pytest.raises(ValueError, match="unsupported device"):
        rc.FusedOps(cfg, "meta")


_ISOLATED_IO = """
import os, tempfile
from lanczos_torch import cli, io
from lanczos_torch.io import formats, jpeg, png
from lanczos_torch.io._native import native_paths
from lanczos_torch.io.loader import FrameLoader, FrameWriter
assert native_paths() == {"png": True, "jpeg": True, "gif": True}
rgb = np.arange(12 * 10 * 3, dtype=np.uint8).reshape(12, 10, 3)
for fmt in ("png", "jpg", "bmp", "tga", "ppm", "pgm", "hdr", "gif"):
    im = rgb[..., :1] if fmt == "pgm" else rgb
    data = io.encode_image(im, fmt)
    got = formats.decode_tga(data) if fmt == "tga" else io.decode_image(data)
    assert got.shape[:2] == (12, 10), fmt
    io.probe_image(data, tga=fmt == "tga")
    if fmt != "tga":
        io.decode_image_16(data)
formats.decode_hdr(io.encode_image(rgb.astype(np.float32), "hdr"))
formats.decode_gif_frames(io.encode_gif(np.stack([rgb, rgb[::-1]]), delays_cs=[3, 4]))
import struct
psd = (b"8BPS" + struct.pack(">H", 1) + bytes(6) + struct.pack(">HIIHH", 3, 12, 10, 8, 3)
       + bytes(12) + struct.pack(">H", 0) + rgb.transpose(2, 0, 1).tobytes())
pic = (b"\\x53\\x80\\xf6\\x34" + bytes(84) + b"PICT" + struct.pack(">HHfHH", 10, 12, 1.0, 3, 0)
       + bytes((0, 8, 0, 0xE0)) + rgb.tobytes())
for data in (psd, pic):
    assert io.decode_image(data).shape == (12, 10, 3) and io.probe_image(data).width == 10
jpeg.decode(jpeg.encode(rgb, quality=50))
png.decode16(png.encode(rgb))
io.convert_channels(rgb, 1)
d = tempfile.mkdtemp()
src = os.path.join(d, "in.png")
io.write_image(src, rgb)
assert cli.main([src, os.path.join(d, "o.png"), "--device", "cpu", "--bench", "1"]) == 0
assert cli.main([src, "--info"]) == 0
io.write_y4m(os.path.join(d, "v.y4m"), [(rgb[..., 0],)], colorspace="mono")
assert cli.main([os.path.join(d, "v.y4m"), "--profile", "hls", "--device", "cpu"]) == 0
with FrameWriter(encode_workers=2) as w:
    for k, (p, im) in enumerate(FrameLoader([src, os.path.join(d, "o.png")])):
        w.write(os.path.join(d, f"w{k}.jpg"), im)
from lanczos_torch.entry import dryrun_multichip
dryrun_multichip(2, ["cpu"] * 2)
"""


def test_import_without_jax():
    """The port, its codecs, CLI, loader, entry points, profiling module,
    certification harness and benchmark scripts (``--help``) run with JAX
    made unimportable, and no ``lanczos_tpu`` module is ever loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch, lanczos_torch\n"
        "img = torch.from_numpy(np.arange(16 * 24 * 3, dtype=np.uint8)"
        ".reshape(16, 24, 3))\n"
        "y = lanczos_torch.upscale(img, scale=(2, 1))\n"
        "assert y.shape == (32, 48, 3) and y.dtype == torch.uint8\n"
        + _ISOLATED_IO +
        "from lanczos_torch.utils import profiling\n"
        "assert profiling.chip_spec('cpu') == profiling.CHIP_SPECS['cpu']\n"
        "import runpy\n"
        "for tool in ('hwcert', 'bench', 'bench_suite'):\n"
        "    sys.argv = [tool, '--help']\n"
        "    try:\n"
        "        runpy.run_module('lanczos_torch.tools.' + tool, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (tool, e.code)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'lanczos_tpu'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_no_jax_or_torch_compile_in_port():
    for path in (REPO / "lanczos_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "torch.compile" not in text, path


def _routing_sweep():
    """(profile, in, out, a, overrides) over edge × align × dering ×
    quantize × order × precision × scales, with N > 32 and the a=130
    config no fused plan fits."""
    out = [("hls", (24, 20), (48, 40), 2, {}), ("hls", (24, 20), (36, 30), 3, {}),
           ("c_oracle", (24, 20), (48, 40), 3, {}), ("c_oracle", (24, 20), (36, 30), 2, {}),
           ("precise", (300, 300), (450, 450), 130, {"dering": True}),
           ("precise", (300, 300), (335, 335), 130, {})]  # N = 67
    out += [("precise", (300, 300), (600, 600), 130, kw) for kw in (
        {}, {"dering": True}, {"edge_mode": "drop"}, {"intermediate_quantize": True},
        {"dering": True, "order": "width_first"},
        {"dering": True, "edge_mode": "drop", "normalize": False})]
    shapes = [((24, 20), (48, 40)), ((24, 20), (36, 30)), ((27, 20), (18, 40)),
              ((34, 36), (35, 34)), ((30, 40), (15, 20))]
    variants = [{}, {"edge_mode": "drop"}, {"edge_mode": "drop", "normalize": False},
                {"edge_mode": "reflect", "align": "center"}, {"dering": True},
                {"dering": True, "order": "width_first"}, {"intermediate_quantize": True},
                {"order": "width_first", "precision": "bf16"},
                {"dering": True, "edge_mode": "drop", "normalize": False}]
    for i, (shape, o) in enumerate(shapes):
        for kw in variants[i % 2 :: 2] if i else variants:
            out.append(("precise", shape, o, 3, kw))
    return out


@pytest.mark.parametrize("profile,shape,out,a,kw", _routing_sweep())
def test_routing_matches_tpu(profile, shape, out, a, kw):
    """The port's eligibility rules equal the JAX package's, and ``auto``
    picks the JAX fallback chain wherever it does not pick a CUDA kernel
    (the JAX ``_pallas_auto_eligible`` is false on the CPU, so its chain
    is all that compares there)."""
    from lanczos_tpu.models import upscaler as tpu_up

    from lanczos_torch.models import upscaler as up_mod

    cfg = lanczos_torch.ResampleConfig.from_profile(profile, shape, out_shape=out, a=a, **kw)
    tkw = {k: v for k, v in kw.items() if k != "precision"}
    tcfg = lanczos_tpu.ResampleConfig.from_profile(
        profile, shape, out_shape=out, a=a, precision=kw.get("precision", "fp32"), **tkw
    ) if profile == "precise" else lanczos_tpu.ResampleConfig.from_profile(
        profile, shape, out_shape=out, a=a)
    assert up_mod._shift_eligible(cfg) == tpu_up._shift_eligible(tcfg)
    assert up_mod._block_eligible(cfg) == tpu_up._block_eligible(tcfg)
    up = lanczos_torch.Upscaler(cfg, device="cpu")
    if up.backend != "cuda":
        assert up.backend == lanczos_tpu.Upscaler(tcfg).backend
    else:
        assert up_mod._cuda_auto_eligible(cfg) and profile == "precise"


@pytest.mark.parametrize("backend", ["auto", "cuda", "pallas"])
@pytest.mark.parametrize("kw", [{}, {"order": "width_first", "dering": True}])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_float_and_uint16_on_kernel_backends_match_tpu_fallback(backend, kw, dtype):
    """float / uint16 input through the kernel backends equals the JAX
    ``_float_fallback_fn`` (strided where eligible, else block)."""
    shape, scale = (24, 20), (3, 2)
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", shape, scale=scale, **kw)
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", shape, scale=scale, **kw)
    rng = np.random.default_rng(12)
    img = (rng.random(shape + (3,), dtype=np.float32) * 255 if dtype == np.float32
           else rng.integers(0, 65536, shape + (3,), dtype=np.uint16))
    up = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")
    assert up.path == "cuda"
    got = up(torch.from_numpy(img)).numpy()
    tup = lanczos_tpu.Upscaler(tcfg)
    y = np.asarray(tup._float_fallback_fn(img.astype(np.float32)))
    want = y if dtype == np.float32 else np.trunc(np.clip(y, 0, 65535)).astype(np.uint16)
    assert got.dtype == dtype
    _close(got, want)


@pytest.mark.parametrize("kw", [{}, {"edge_mode": "reflect", "align": "center"},
                                {"intermediate_quantize": True}])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ref_backend_matches_tpu_ref(kw, dtype):
    """``backend="ref"`` runs the host oracle and returns on the input's
    device, equal to the JAX package's ``ref`` backend."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (20, 16), scale=(3, 2), **kw)
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", (20, 16), scale=(3, 2), **kw)
    img = _img((2, 20, 16, 3), seed=13).astype(dtype)
    up = lanczos_torch.Upscaler(cfg, backend="ref", device="cpu")
    got = up(torch.from_numpy(img))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="ref")(img))
    assert up.path == "ref" and got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("profile,backend", [("precise", "xla"), ("precise", "shift_xla"),
                                             ("precise", "block"), ("hls", "auto"),
                                             ("c_oracle", "auto")])
def test_table_bytes_count_every_path(profile, backend):
    """The cache's size estimate counts each path's tables, and grows
    when a path's float fallback is built."""
    from lanczos_torch.models.upscaler import _device_table_bytes

    cfg = lanczos_torch.ResampleConfig.from_profile(profile, (16, 24), scale=(2, 1), a=2)
    up = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")
    assert _device_table_bytes(up) > 0
    kernels = lanczos_torch.Upscaler(
        lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1)),
        device="cpu")
    before = _device_table_bytes(kernels)
    kernels(torch.zeros((16, 24, 3)))
    assert _device_table_bytes(kernels) > before
