"""The port's fused plan and the plain PyTorch version of its CUDA kernel,
held to the JAX package on the same seeded inputs.

- the plain version on the JAX kernel's own plan (``plan_from_reference``)
  against ``PallasOps(..., interpret=True, variant="mxu")``;
- the plain version on the port's own plan against the JAX gather path;
- the CUDA kernel's host-side layout (padding, transposes, launch
  arguments), through a numpy re-enactment of the kernel's loops.

Limits (``hwcert.py``'s contract): fp32 ≤ 1 LSB on ≤ 1% of pixels (the
TPU kernel's fp32 is a hi/lo bf16 split, the port's plain fp32); bf16
≤ 3 LSB on ≤ 50% of pixels.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as TpuConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as TpuUpscaler  # noqa: E402
from lanczos_tpu.ops.resample_pallas import (  # noqa: E402
    PallasOps,
    resample_2d_pallas,
)

from lanczos_torch.core.config import ResampleConfig  # noqa: E402
from lanczos_torch.core.weights import banded_weights  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}

# (in (h, w), scale, overrides): multi-tile, multi-block and ragged edges
SHAPES = [
    ((40, 200), (2, 1), {}),
    ((64, 320), (3, 2), {}),
    ((36, 100), (2, 1), {"align": "center"}),
    ((30, 72), (4, 3), {"edge_mode": "reflect"}),
    ((48, 64), (3, 1), {"edge_mode": "drop", "normalize": False}),
]


def _within(got, want, precision):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    lim, frac_lim = LIMITS[precision]
    assert d.max() <= lim, f"max |d| {d.max()} > {lim}"
    assert (d > 0).mean() <= frac_lim, f"{(d > 0).mean():.4f} of pixels differ"


def _img(shape, seed=0):
    """Gradients plus noise (as the JAX tests' ``small_img``): uniform noise
    would put about half of all pixels on a bf16 rounding flip, the very
    edge of the bf16 limit, where photographs put far fewer."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (yy + xx) * 255 // max(h + w - 2, 1)], axis=-1)
    noise = rng.integers(-40, 40, size=base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _planar(img):
    """(H, W, C) numpy → (C, H, W) torch."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(img, (2, 0, 1))))


def _interleaved(y):
    return np.transpose(y.numpy(), (1, 2, 0))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw", SHAPES)
def test_plain_on_tpu_plan_matches_pallas_mxu(shape, scale, kw, precision):
    """Both precisions against the TPU kernel's fp32 (hi/lo split) output.
    The port's bf16 rounds each output's taps so that they keep their sum
    (``plan_weights``); the TPU's bf16 rounds each tap to nearest, which
    biases bright pixels and is itself past the bf16 limit against the
    exact result on the center-aligned shape."""
    cfg = TpuConfig.from_profile("precise", shape, scale=scale, a=3, **kw)
    ops = PallasOps(cfg, interpret=True, variant="mxu", tile_h=16)
    img = _img(shape)
    want = np.asarray(resample_2d_pallas(img, ops))
    plan = rc.plan_from_reference(vars(ops.mxu))
    got = rc.fused_resample_reference(_planar(img), plan, precision, cfg.out_shape)
    _within(_interleaved(got), want, precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw", SHAPES + [((64, 96), (1, 2), {})])
def test_plain_on_own_plan_matches_tpu_gather(shape, scale, kw, precision):
    """The gather path runs in fp32 for both: its bf16 mode rounds more
    often than the fused kernels and is no reference for them."""
    cfg = ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    plan = rc.fused_plan(cfg)
    assert plan is not None
    img = _img(shape, seed=1)
    tpu_cfg = TpuConfig.from_profile("precise", shape, scale=scale, a=3, **kw)
    want = np.asarray(TpuUpscaler(tpu_cfg, backend="xla")(img))
    got = rc.fused_resample_reference(_planar(img), plan, precision, cfg.out_shape)
    _within(_interleaved(got), want, precision)


def test_plan_from_reference_carries_the_tpu_matrices():
    cfg = TpuConfig.from_profile("precise", (40, 200), scale=(2, 1), a=3)
    mx = PallasOps(cfg, interpret=True, variant="mxu", tile_h=16).mxu
    fields = {k: getattr(mx, k) for k in (
        "wv", "wh", "starts_v", "starts_h", "uniq_h", "tile_out", "kv", "kh",
        "cb", "n_cb", "num_tiles",
    )}
    plan = rc.plan_from_reference(fields)
    np.testing.assert_array_equal(plan.wv, mx.wv)
    np.testing.assert_array_equal(plan.wh, mx.wh)
    assert list(plan.starts_v) == list(mx.starts_v)
    assert list(plan.uniq_h) == list(mx.uniq_h)
    assert plan.center_v is None and plan.center_h is None
    # a dering plan: the one-hot bound rows and columns become the offsets
    dering = TpuConfig.from_profile("precise", (40, 200), scale=(2, 1), dering=True)
    dx = PallasOps(dering, interpret=True, variant="mxu", tile_h=16).mxu
    dplan = rc.plan_from_reference(vars(dx))
    t, cb = dx.tile_out, dx.cb
    np.testing.assert_array_equal(dplan.wv, dx.wv[:, :t])
    np.testing.assert_array_equal(dplan.wh, dx.wh[:, :, :cb])
    s = 3
    op_v = banded_weights(40, 80, a=3)
    for i in range(dx.num_tiles):
        lo, hi = i * t, min((i + 1) * t, 80)
        want = op_v.idx[lo:hi, s - 1 : s + 1].T - dx.starts_v[i]
        np.testing.assert_array_equal(dplan.center_v[i, :, : hi - lo], want)
        assert dx.wv[i, t + np.arange(hi - lo), want[0]].all()
    op_h = banded_weights(200, 400, a=3)
    for b in range(dx.n_cb):
        lo, hi = b * cb, min((b + 1) * cb, 400)
        want = op_h.idx[lo:hi, s - 1 : s + 1].T - dx.starts_h[b]
        np.testing.assert_array_equal(dplan.center_h[dx.uniq_h[b], :, : hi - lo], want)
    bad = dict(vars(dx), wv=dx.wv.copy())
    bad["wv"][0, t, 0] = 0.5  # not one-hot
    with pytest.raises(ValueError, match="one-hot"):
        rc.plan_from_reference(bad)


def test_main_path_plan_geometry():
    """4K→8K Lanczos-3: 64-row tiles and 128-column blocks, three unique
    horizontal matrices, and one block's band and intermediate well inside
    the 48 KB of static shared memory."""
    cfg = ResampleConfig.from_profile("precise", (2160, 3840), scale=(2, 1), a=3)
    p = rc.fused_plan(cfg)
    assert (p.tile_out, p.num_tiles, p.cb, p.n_cb) == (64, 68, 128, 60)
    assert (p.kv, p.kh, p.wh.shape[0]) == (37, 69, 3)
    assert p.smem_bytes() < 48 * 1024


@pytest.mark.parametrize("shape,scale,kw", SHAPES + [((64, 96), (1, 2), {})])
def test_plan_bands_cover_every_tap(shape, scale, kw):
    """Every tap of every output lies inside its tile's and block's band,
    and the dense matrices reproduce the banded operators."""
    cfg = ResampleConfig.from_profile("precise", shape, scale=scale, a=3, **kw)
    plan = rc.fused_plan(cfg)
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    opk = dict(a=3, edge_mode=cfg.edge_mode, normalize=cfg.normalize,
               align=cfg.align.value)
    dv = banded_weights(ih, oh, **opk).dense()
    dh = banded_weights(iw, ow, **opk).dense()
    rv = np.zeros((oh, ih + plan.kv))
    for i in range(plan.num_tiles):
        s, r = plan.starts_v[i], slice(i * plan.tile_out, (i + 1) * plan.tile_out)
        rv[r, s : s + plan.kv] = plan.wv[i][: oh - i * plan.tile_out]
    np.testing.assert_allclose(rv[:, :ih], dv, atol=1e-15)
    assert not rv[:, ih:].any()
    rh = np.zeros((iw + plan.kh, ow))
    for b in range(plan.n_cb):
        s, c = plan.starts_h[b], slice(b * plan.cb, (b + 1) * plan.cb)
        rh[s : s + plan.kh, c] = plan.wh[plan.uniq_h[b]][:, : ow - b * plan.cb]
    np.testing.assert_allclose(rh[:iw].T, dh, atol=1e-15)
    assert not rh[iw:].any()


def _emulate_kernel(x, lay, oh, ow, bf16, dering=False, quant=False):
    """The CUDA kernel's loops in numpy, on its host layout: per (block,
    tile, plane), a masked band of kh_p zero-padded columns, the vertical
    product against wvT[i] into midT (kh_p × tile_p), with dering clamped
    to the band rows ``cv[i]`` names, with ``quant`` trunc-clipped, in bf16
    rounded; then the horizontal product against wh[uniq_h[b]], with
    dering clamped to the midT columns ``ch[uniq_h[b]]`` names, and a
    masked trunc-clip store."""
    nc, h, w = x.shape
    out = np.full((nc, oh, ow), 7, np.uint8)  # stores must cover every pixel
    tile, tile_p, kv = lay["tile"], lay["tile_p"], lay["kv"]
    cb, cb_p, kh, kh_p = lay["cb"], lay["cb_p"], lay["kh"], lay["kh_p"]
    assert tile_p % 8 == 0 and kh_p % 8 == 0 and cb_p % 4 == 0
    assert lay["wvT"].shape == (lay["num_tiles"], kv, tile_p)
    assert lay["wh"].shape[1:] == (kh, cb_p)
    if dering:
        assert lay["cv"].shape == (lay["num_tiles"], 2, tile_p)
        assert lay["ch"].shape == (lay["wh"].shape[0], 2, cb_p)

    def clamp(v, a, b):
        return np.minimum(np.maximum(v, np.minimum(a, b)), np.maximum(a, b))

    for p in range(nc):
        for i in range(lay["num_tiles"]):
            for b in range(lay["n_cb"]):
                r0, c0 = lay["starts_v"][i], lay["starts_h"][b]
                band = np.zeros((kv, kh_p), np.float32)
                rr = np.arange(kv)[:, None] + r0
                cc = np.arange(kh_p)[None, :] + c0
                ok = (np.arange(kh_p)[None, :] < kh) & (rr < h) & (cc < w)
                band[ok] = x[p][np.minimum(rr, h - 1), np.minimum(cc, w - 1)][ok]
                midT = band.T @ lay["wvT"][i]  # (kh_p, tile_p)
                if dering:
                    cv = lay["cv"][i]
                    midT = clamp(midT, band[cv[0]].T, band[cv[1]].T)
                if quant:
                    midT = np.trunc(np.clip(midT, 0, 255))
                if bf16:
                    midT = torch.from_numpy(midT).bfloat16().float().numpy()
                u = lay["uniq_h"][b]
                acc = midT[:kh].T @ lay["wh"][u]  # (tile_p, cb_p)
                if dering:
                    ch = lay["ch"][u]
                    acc = clamp(acc, midT[ch[0]].T, midT[ch[1]].T)
                rows = min(tile, oh - i * tile)
                cols = min(cb, ow - b * cb)
                q = np.trunc(np.clip(acc[:rows, :cols], 0, 255)).astype(np.uint8)
                out[p, i * tile : i * tile + rows, b * cb : b * cb + cols] = q
    return out


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw,tiles", [
    ((20, 150), (2, 1), {}, (64, 128)),  # one ragged tile, ragged blocks
    ((30, 70), (3, 2), {"align": "center"}, (16, 384)),
    ((24, 40), (1, 2), {}, (8, 16)),
    ((24, 33), (4, 3), {}, (13, 20)),  # tile_p padding
])
def test_kernel_layout_reenacted(shape, scale, kw, tiles, precision):
    from lanczos_torch.core.config import reduced_scale

    cfg = ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    nv, dv = reduced_scale(ih, oh)
    opk = dict(a=3, align=cfg.align.value)
    off_v = 0 if cfg.align.value == "zero" else dv - nv
    plan = rc.build_fused_plan(
        cfg, tiles[0], banded_weights(ih, oh, **opk), banded_weights(iw, ow, **opk),
        nv, dv, off_v, tiles[1],
    )
    lay = rc.kernel_layout(plan, cfg.precision)
    x = _img(shape, seed=2).transpose(2, 0, 1).copy()
    got = _emulate_kernel(x, lay, oh, ow, precision == "bf16")
    want = rc.fused_resample_reference(torch.from_numpy(x), plan, precision, (oh, ow))
    d = np.abs(got.astype(np.int32) - want.numpy().astype(np.int32))
    lim, frac_lim = LIMITS["fp32"]  # same rounding points: only sum order differs
    assert d.max() <= lim and (d > 0).mean() <= frac_lim


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw,tiles", [
    ((20, 150), (2, 1), {"dering": True}, (64, 128)),  # ragged tile and blocks
    ((30, 70), (3, 2), {"dering": True, "align": "center"}, (16, 384)),
    ((24, 33), (4, 3), {"dering": True, "intermediate_quantize": True}, (13, 20)),
    ((24, 40), (2, 1), {"intermediate_quantize": True}, (8, 16)),
    ((24, 40), (3, 2), {"dering": True, "edge_mode": "drop", "normalize": False}, (8, 16)),
])
def test_kernel_layout_reenacted_nonlinear(shape, scale, kw, tiles, precision):
    """The dering and quantize instantiations' host layout (the padded
    central-tap offsets ``cv``/``ch``) through the kernel's loops."""
    from lanczos_torch.core.config import reduced_scale

    cfg = ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    (ih, iw), (oh, ow) = cfg.in_shape, cfg.out_shape
    nv, dv = reduced_scale(ih, oh)
    opk = dict(a=3, align=cfg.align.value, edge_mode=cfg.edge_mode,
               normalize=cfg.normalize)
    off_v = 0 if cfg.align.value == "zero" else dv - nv
    plan = rc.build_fused_plan(
        cfg, tiles[0], banded_weights(ih, oh, **opk), banded_weights(iw, ow, **opk),
        nv, dv, off_v, tiles[1],
    )
    lay = rc.kernel_layout(plan, cfg.precision)
    assert ("cv" in lay) == cfg.dering
    x = _img(shape, seed=2).transpose(2, 0, 1).copy()
    got = _emulate_kernel(x, lay, oh, ow, precision == "bf16", cfg.dering,
                          cfg.intermediate_quantize)
    want = rc.fused_resample_reference(torch.from_numpy(x), plan, precision, (oh, ow),
                                       cfg.dering, cfg.intermediate_quantize)
    d = np.abs(got.astype(np.int32) - want.numpy().astype(np.int32))
    lim = 2 if cfg.intermediate_quantize else 1  # same rounding points, other sum order
    assert d.max() <= lim and (d > 0).mean() <= 0.01


def test_fused_call_cpu_runs_plain_version_and_counts_no_launch():
    cfg = ResampleConfig.from_profile("precise", (20, 30), scale=(2, 1), a=3)
    ops = rc.FusedOps(cfg, "cpu")
    before = dict(rc.launches)
    x = torch.from_numpy(_img((20, 30)).transpose(2, 0, 1).copy())
    y = rc.fused_call(ops, x)
    assert y.shape == (3, 40, 60) and y.dtype == torch.uint8
    assert rc.launches == before
    with pytest.raises(ValueError, match="expected"):
        rc.fused_call(ops, x.float())
    with pytest.raises(NotImplementedError, match="row-sharded"):
        rc.fused_call(ops, x, wv=(ops.plan.wv, ops.plan.wv))


def test_hand_built_plan_is_checked():
    cfg = ResampleConfig.from_profile("precise", (20, 30), scale=(2, 1), a=3)
    plan = rc.fused_plan(cfg)
    assert rc.make_fused_ops(cfg, plan, "cpu").plan is plan
    bad = [
        dict(starts_v=plan.starts_v - 40),
        dict(uniq_h=plan.uniq_h + plan.wh.shape[0]),
        dict(num_tiles=plan.num_tiles - 1, wv=plan.wv[:-1],
             starts_v=plan.starts_v[:-1]),
    ]
    for change in bad:
        with pytest.raises(ValueError, match="plan does not fit"):
            rc.make_fused_ops(cfg, dataclasses.replace(plan, **change), "cpu")


def test_build_needs_nvcc_and_is_keyed_by_the_sources(monkeypatch, tmp_path):
    from lanczos_torch.ops import _build

    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert "fused_resample.cu" in [s.name for s in _build._sources()]
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
