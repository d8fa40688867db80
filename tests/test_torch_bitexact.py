"""The bit-exact profiles in the port: ``hls`` (``ops/fixed_point``, int32)
and ``c_oracle`` (``ops/c_exact``, int64), on the CPU, byte-equal to
``lanczos_tpu``'s device paths, to the JAX package's host oracles and to the
port's copies of them (``lanczos_torch.ref``), and to the checked-in golden
PNGs.  Equality, not tolerance: both are integer arithmetic.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.io import read_png  # noqa: E402
from lanczos_tpu.ops.c_exact import CExactOps as TpuCExactOps  # noqa: E402
from lanczos_tpu.ops.fixed_point import HLSOps as TpuHLSOps  # noqa: E402
from lanczos_tpu.ref import hls_sim as tpu_hls_sim  # noqa: E402
from lanczos_tpu.ref import oracle as tpu_oracle  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import c_exact, fixed_point  # noqa: E402
from lanczos_torch.ref import hls_sim, oracle  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
OVERFLOW = "ignore:HLS schedule indexes past:RuntimeWarning"


@pytest.fixture
def small_img():
    """The JAX tests' 24×20 gradient-plus-noise image (seed 42)."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:24, 0:20]
    base = np.stack([yy * 255 // 23, xx * 255 // 19, (yy + xx) * 255 // 42], axis=-1)
    return np.clip(base + rng.integers(-40, 40, size=base.shape), 0, 255).astype(np.uint8)


def _cfgs(profile, shape, **kw):
    return (lanczos_torch.ResampleConfig.from_profile(profile, shape, **kw),
            lanczos_tpu.ResampleConfig.from_profile(profile, shape, **kw))


def _port(cfg, img, backend="auto"):
    up = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")
    return up, up(torch.from_numpy(img)).numpy()


@pytest.mark.filterwarnings(OVERFLOW)
@pytest.mark.parametrize("a", [2, 3])
@pytest.mark.parametrize("scale", [(2, 1), (3, 1), (3, 2)])
def test_hls_bit_exact(small_img, a, scale):
    cfg, tcfg = _cfgs("hls", small_img.shape[:2], scale=scale, a=a)
    up, got = _port(cfg, small_img)
    assert up.path == "hls" and got.dtype == np.uint8
    out = cfg.out_shape
    np.testing.assert_array_equal(got, np.asarray(lanczos_tpu.Upscaler(tcfg)(small_img)))
    np.testing.assert_array_equal(got, tpu_hls_sim.hls_stream_upscale(small_img, *out, a, 8))
    np.testing.assert_array_equal(got, hls_sim.hls_stream_upscale(small_img, *out, a, 8))


@pytest.mark.parametrize("bit_precision", [6, 8, 10])
def test_hls_bit_exact_other_precisions(small_img, bit_precision):
    cfg, tcfg = _cfgs("hls", small_img.shape[:2], scale=(2, 1), a=2,
                      bit_precision=bit_precision)
    _, got = _port(cfg, small_img)
    np.testing.assert_array_equal(got, np.asarray(lanczos_tpu.Upscaler(tcfg)(small_img)))
    np.testing.assert_array_equal(
        got, hls_sim.hls_stream_upscale(small_img, *cfg.out_shape, 2, bit_precision))


@pytest.mark.filterwarnings(OVERFLOW)
@pytest.mark.parametrize("scale,a", [((2, 1), 2), ((3, 2), 3)])
def test_hls_tables_from_reference(small_img, scale, a):
    """The port's ``HLSOps`` on the JAX ``HLSOps``' own tables: the same
    tables as its own build, and the same bytes."""
    cfg, tcfg = _cfgs("hls", small_img.shape[:2], scale=scale, a=a)
    tops = TpuHLSOps.build(tcfg)
    fields = {k: np.asarray(getattr(tops, k)) for k in fixed_point._FIELDS}
    ops = fixed_point.HLSOps.from_reference(cfg, fields)
    own = fixed_point.HLSOps.build(cfg)
    for k in fixed_point._FIELDS:
        assert torch.equal(getattr(ops, k), getattr(own, k)), k
    got = fixed_point.hls_upscale(torch.from_numpy(small_img), ops).numpy()
    np.testing.assert_array_equal(got, np.asarray(lanczos_tpu.Upscaler(tcfg)(small_img)))


@pytest.mark.filterwarnings(OVERFLOW)
def test_hls_batched_and_short_inputs():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, size=(2, 16, 12, 3), dtype=np.uint8)
    cfg, _ = _cfgs("hls", (16, 12), scale=(2, 1), a=2)
    _, got = _port(cfg, imgs)
    for b in range(2):
        np.testing.assert_array_equal(got[b], hls_sim.hls_stream_upscale(imgs[b], 32, 24))
    short = rng.integers(0, 256, size=(2, 3, 3), dtype=np.uint8)  # fewer than a+1 rows
    cfg, _ = _cfgs("hls", (2, 3), scale=(2, 1), a=2)
    _, got = _port(cfg, short)
    np.testing.assert_array_equal(got, hls_sim.hls_stream_upscale(short, 4, 6, a=2))


def test_hls_lut_overflow_warns_and_downscale_refused():
    cfg, _ = _cfgs("hls", (300, 20), scale=(3, 1), a=2)
    with pytest.warns(RuntimeWarning, match="past the a\\*N ROM"):
        fixed_point.HLSOps.build(cfg)
    down = lanczos_torch.ResampleConfig.from_profile("hls", (40, 40), scale=(1, 2), a=2)
    with pytest.raises(ValueError, match="upscale-only"):
        lanczos_torch.Upscaler(down, device="cpu")
    with pytest.raises(ValueError, match="upscale-only"):
        hls_sim.hls_stream_upscale(np.zeros((40, 40, 3), np.uint8), 20, 20)


@pytest.mark.parametrize("a", [2, 3])
@pytest.mark.parametrize(
    "shape,scale",
    [((64, 48), (2, 1)), ((40, 48), (3, 1)), ((36, 44), (3, 2)), ((44, 40), (5, 4))],
)
def test_c_oracle_bit_exact(a, shape, scale):
    h, w = shape
    n, d = scale
    cfg, tcfg = _cfgs("c_oracle", shape, scale=scale, a=a)
    img = np.random.default_rng(42).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    up, got = _port(cfg, img)
    assert up.backend == up.path == "c_exact" and got.dtype == np.uint8
    want = tpu_oracle.c_oracle_upscale(img, h * n // d, w * n // d, a)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.c_oracle_upscale(img, h * n // d, w * n // d, a))
    if (shape, a) in (((64, 48), 3), ((36, 44), 2)):  # the JAX device path: compile-heavy
        np.testing.assert_array_equal(got, np.asarray(TpuCExactOps(tcfg)(img)))


@pytest.mark.parametrize("a,shape,scale", [(3, (20, 16), (2, 1)), (2, (30, 24), (4, 3))])
def test_c_oracle_banded_passes_equal_unbanded(monkeypatch, a, shape, scale):
    """Bands forced small (a 40-row output in three, the width pass in
    more): the banded passes give the unbanded bytes and the host oracle's,
    the in-place quirk rows included."""
    (h, w), (n, d) = shape, scale
    cfg, _ = _cfgs("c_oracle", shape, scale=scale, a=a)
    img = np.random.default_rng(7).integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    ops = c_exact.CExactOps(cfg)
    assert ops.fix_rows  # the quirk rows read whole passes, past any band
    whole = ops(torch.from_numpy(img)).numpy()
    oh, ow = h * n // d, w * n // d
    assert oh == 40
    # height pass rows hold 2 * ow * 3 values: 14 rows a band -> 14 + 14 + 12
    monkeypatch.setattr(c_exact, "BAND_BYTES", 14 * c_exact._BAND_LIVE * 8 * 2 * ow * 3)
    assert c_exact._band_rows(2 * ow * 3) == 14 and c_exact._band_rows(2 * h * 3) < ow
    banded = ops(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(banded, whole)
    for b in range(2):
        np.testing.assert_array_equal(banded[b], oracle.c_oracle_upscale(img[b], oh, ow, a))


def test_c_oracle_band_rows_keep_a_band_under_the_limit():
    """At 4K→8K a band of either pass holds under BAND_BYTES of int64
    temporaries, and a pass takes several bands."""
    for trailing, out_n in ((2160 * 3, 7680), (7680 * 3, 4320)):
        rows = c_exact._band_rows(trailing)
        assert 1 <= rows < out_n
        assert rows * trailing * 8 * c_exact._BAND_LIVE <= c_exact.BAND_BYTES


def test_c_oracle_batched_and_leading_dims():
    rng = np.random.default_rng(2)
    cfg, _ = _cfgs("c_oracle", (32, 24), scale=(2, 1), a=3)
    imgs = rng.integers(0, 256, size=(3, 32, 24, 3), dtype=np.uint8)
    _, got = _port(cfg, imgs)
    for b in range(3):
        np.testing.assert_array_equal(got[b], oracle.c_oracle_upscale(imgs[b], 64, 48, 3))
    up, got5 = _port(cfg, imgs.reshape(3, 1, 32, 24, 3), backend="c_exact")
    assert up.path == "c_exact"
    np.testing.assert_array_equal(got5.reshape(got.shape), got)


def test_c_oracle_extreme_values():
    """All-0 / all-255 / checker images stress the walk's p=0, p=2^k and
    p=255 cases."""
    cfg, tcfg = _cfgs("c_oracle", (24, 24), scale=(2, 1), a=3)
    imgs = np.stack([
        np.zeros((24, 24, 3), np.uint8),
        np.full((24, 24, 3), 255, np.uint8),
        np.full((24, 24, 3), 128, np.uint8),  # p = 2^7 exactly
        np.indices((24, 24)).sum(0).astype(np.uint8)[..., None].repeat(3, -1) % 2 * 255,
        np.full((24, 24, 3), 1, np.uint8),  # p = 2^0, binade edge
    ])
    _, got = _port(cfg, imgs)
    want = np.asarray(TpuCExactOps(tcfg)(imgs))
    np.testing.assert_array_equal(got, want)
    for g, img in zip(got, imgs):
        np.testing.assert_array_equal(g, oracle.c_oracle_upscale(img, 48, 48, 3))


@pytest.mark.parametrize("shape,scale,a", [((20, 16), (2, 1), 3), ((18, 22), (3, 2), 2)])
def test_c_exact_tables_from_reference(shape, scale, a):
    cfg, tcfg = _cfgs("c_oracle", shape, scale=scale, a=a)
    tops = TpuCExactOps(tcfg)
    ops = c_exact.CExactOps.from_reference(cfg, tops.tbl_h, tops.tbl_v)
    own = c_exact.CExactOps(cfg)
    assert ops.fix_rows == own.fix_rows == tops.fix_rows
    for t, o in ((ops.tbl_h, own.tbl_h), (ops.tbl_v, own.tbl_v)):
        for f in c_exact._AxisTables._fields:
            assert np.array_equal(getattr(t, f), getattr(o, f)), f
    img = np.random.default_rng(3).integers(0, 256, size=shape + (3,), dtype=np.uint8)
    got = ops(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(tops(img)))


def test_c_exact_needs_c_faithful():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 16), scale=(2, 1))
    with pytest.raises(ValueError, match="c_faithful"):
        c_exact.CExactOps(cfg)
    with pytest.raises(ValueError, match="c_faithful"):
        lanczos_torch.Upscaler(cfg, backend="c_exact", device="cpu")


@pytest.mark.parametrize("profile,scale,a,bp,name", [
    ("c_oracle", (2, 1), 2, None, "golden_c_oracle_2x_a2.png"),
    ("hls", (2, 1), 2, None, "golden_hls_2x_a2.png"),
    ("c_oracle", (2, 1), 3, None, "golden_c_oracle_2x_a3.png"),
    ("hls", (2, 1), 3, None, "golden_hls_2x_a3.png"),
    ("c_oracle", (3, 2), 2, None, "golden_c_oracle_3over2_a2.png"),
    ("hls", (3, 2), 2, None, "golden_hls_3over2_a2.png"),
    ("hls", (2, 1), 2, 6, "golden_hls_2x_a2_p6.png"),
    ("hls", (2, 1), 2, 10, "golden_hls_2x_a2_p10.png"),
])
def test_goldens_bit_exact(profile, scale, a, bp, name):
    img = read_png(os.path.join(DATA, "input_48x40.png"))
    kw = dict(scale=scale, a=a) | ({"bit_precision": bp} if bp is not None else {})
    out = lanczos_torch.upscale(torch.from_numpy(img), profile=profile, **kw)
    np.testing.assert_array_equal(out.numpy(), read_png(os.path.join(DATA, name)))


@pytest.mark.parametrize("profile", ["hls", "c_oracle"])
def test_uint16_refused_by_bit_exact_profiles(profile):
    cfg, _ = _cfgs(profile, (16, 16), scale=(2, 1), a=2)
    for backend in ("auto", "ref"):
        up = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")
        with pytest.raises(ValueError, match="uint16"):
            up(torch.zeros((16, 16, 3), dtype=torch.uint16))


@pytest.mark.parametrize("profile", ["hls", "c_oracle"])
def test_ref_backend_matches_tpu_ref(small_img, profile):
    cfg, tcfg = _cfgs(profile, small_img.shape[:2], scale=(2, 1), a=2)
    imgs = np.stack([small_img, small_img[::-1]])
    up, got = _port(cfg, imgs, backend="ref")
    assert up.path == "ref" and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(lanczos_tpu.Upscaler(tcfg, "ref")(imgs)))
    _, dev = _port(cfg, imgs)
    np.testing.assert_array_equal(got, dev)
