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


@pytest.mark.parametrize("make,match", [
    (lambda: lanczos_torch.ResampleConfig.from_profile(
        "hls", (16, 24), scale=(2, 1), a=2), "queue 1, item 6"),
    (lambda: lanczos_torch.ResampleConfig.from_profile(
        "c_oracle", (16, 24), scale=(2, 1)), "queue 1, item 6"),
    # nonlinear configs without a fused plan that v2 does not take either
    (lambda: lanczos_torch.ResampleConfig(
        (4096, 4096), (64, 64), dering=True), "dering"),
    (lambda: lanczos_torch.ResampleConfig(
        (4096, 4096), (64, 64), intermediate_quantize=True), "quantized"),
    (lambda: lanczos_torch.ResampleConfig((4096, 4096), (64, 64)), "no fused plan"),
])
def test_unported_configs_raise(make, match):
    with pytest.raises(NotImplementedError, match=match):
        lanczos_torch.Upscaler(make(), device="cpu")


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
def test_non_uint8_input_raises(dtype):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    up = lanczos_torch.Upscaler(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="gather path"):
        up(torch.zeros((16, 24, 3), dtype=dtype))
    with pytest.raises(NotImplementedError, match="gather path"):
        up.planar(torch.zeros((3, 16, 24), dtype=dtype))


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
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (288, 480), out_shape=(18, 30))
    up = lanczos_torch.Upscaler(cfg, backend="pallas", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, items 3 and 5"):
        up(torch.zeros((288, 480, 3), dtype=dtype))


def test_unported_backend_raises():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    with pytest.raises(NotImplementedError, match="queue 1"):
        lanczos_torch.Upscaler(cfg, backend="xla")


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


def test_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch, lanczos_torch\n"
        "img = torch.from_numpy(np.arange(16 * 24 * 3, dtype=np.uint8)"
        ".reshape(16, 24, 3))\n"
        "y = lanczos_torch.upscale(img, scale=(2, 1))\n"
        "assert y.shape == (32, 48, 3) and y.dtype == torch.uint8\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'lanczos_tpu'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_or_torch_compile_in_port():
    for path in (REPO / "lanczos_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "torch.compile" not in text, path
