"""The port's fused plan and the plain PyTorch version of its CUDA kernel,
held to the JAX package on the same seeded inputs.

- the plain version on the JAX kernel's own plan (``plan_from_reference``)
  against ``PallasOps(..., interpret=True, variant="mxu")``;
- the plain version on the port's own plan against the JAX gather path;
- the compact form both read (each output's first tap and run of weights,
  and the kernel's shared windows of four outputs) expands back to the
  plan's dense matrices exactly;
- the CUDA kernel's host-side layout (group windows, padding, the aligned
  band and intermediate origins, launch arguments), through a numpy
  re-enactment of the kernel's loops.

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
    tile, plane), the uint8 band from the 16-byte boundary at or below the
    block's first column (zero past the image); the vertical pass, per
    group of four tile rows a sum over the group's window ``base_v ..
    base_v + win_v`` in step order, over the intermediate's ``mw`` columns
    (from the 8-column boundary at or below the first tap), with dering
    clamped to the band rows ``cv[i]`` names, with ``quant`` trunc-clipped,
    in bf16 rounded; then the horizontal pass, per group of four columns a
    sum over ``base_h .. base_h + win_h``, with dering clamped to the
    intermediate columns ``ch[uniq_h[b]]`` names, the trunc-clip into the
    staged tile (chunks swizzled by row group) and the masked store."""
    nc, h, w = x.shape
    out = np.full((nc, oh, ow), 7, np.uint8)  # stores must cover every pixel
    tile, tile_p, kv = lay["tile"], lay["tile_p"], lay["kv"]
    cb, cb_p, kh = lay["cb"], lay["cb_p"], lay["kh"]
    win_v, win_h, bw, mw, stage_w = (lay[k] for k in ("win_v", "win_h", "bw", "mw", "stage_w"))
    assert tile_p % 8 == 0 and cb_p % 4 == 0 and bw % 16 == 0 and mw % 8 == 0
    assert bw >= mw + 8 and mw >= kh + 7 and stage_w >= cb_p
    chunks = stage_w // 16
    assert chunks & (chunks - 1) == 0 and stage_w % 16 == 0
    mask = min(chunks, 8) - 1
    assert lay["wv"].shape == (lay["num_tiles"], win_v, tile_p // 4, 4)
    assert lay["wh"].shape[1:] == (win_h, cb_p // 4, 4)
    assert lay["base_v"].shape == (lay["num_tiles"], tile_p // 4)
    assert lay["base_h"].shape == (lay["wh"].shape[0], cb_p // 4)
    assert lay["wv"].dtype == lay["wh"].dtype == np.float32
    assert (lay["base_v"] >= 0).all() and (lay["base_v"] + win_v <= kv).all()
    assert (lay["base_h"] >= 0).all() and (lay["base_h"] + win_h <= kh).all()
    if dering:
        assert lay["cv"].shape == (lay["num_tiles"], 2, tile_p)
        assert lay["ch"].shape == (lay["wh"].shape[0], 2, cb_p)

    def clamp(v, a, b):
        return np.minimum(np.maximum(v, np.minimum(a, b)), np.maximum(a, b))

    def window_sum(a, wts):  # a (steps, m), wts (steps, 4) -> (m, 4), in step order
        acc = np.zeros((a.shape[1], 4), np.float32)
        for s in range(a.shape[0]):
            acc = acc + a[s][:, None] * wts[s][None, :]
        return acc

    for p in range(nc):
        for i in range(lay["num_tiles"]):
            for b in range(lay["n_cb"]):
                r0, c0 = int(lay["starts_v"][i]), int(lay["starts_h"][b])
                c_a = c0 & ~15
                joff, dj = (c0 - c_a) & 8, (c0 - c_a) & 7
                band = np.zeros((kv, bw), np.uint8)
                rr = np.arange(kv)[:, None] + r0
                cc = np.arange(bw)[None, :] + c_a
                ok = (rr < h) & (cc < w)
                band[ok] = x[p][np.minimum(rr, h - 1), np.minimum(cc, w - 1)][ok]
                bandf = band[:, joff : joff + mw].astype(np.float32)  # (kv, mw)
                midT = np.zeros((mw, tile_p), np.float32)
                for rg in range(tile_p // 4):
                    base = lay["base_v"][i, rg]
                    acc = window_sum(bandf[base : base + win_v], lay["wv"][i, :, rg])
                    if dering:
                        cv = lay["cv"][i][:, 4 * rg : 4 * rg + 4]
                        acc = clamp(acc, bandf[cv[0]].T, bandf[cv[1]].T)
                    midT[:, 4 * rg : 4 * rg + 4] = acc
                if quant:
                    midT = np.trunc(np.clip(midT, 0, 255))
                if bf16:
                    midT = torch.from_numpy(midT).bfloat16().float().numpy()
                u = lay["uniq_h"][b]
                stage = np.zeros((tile_p, stage_w), np.uint8)
                for cg in range(cb_p // 4):
                    base = dj + lay["base_h"][u, cg]
                    assert base + win_h <= mw
                    acc = window_sum(midT[base : base + win_h], lay["wh"][u, :, cg])
                    if dering:
                        ch = dj + lay["ch"][u][:, 4 * cg : 4 * cg + 4]
                        acc = clamp(acc, midT[ch[0]].T, midT[ch[1]].T)
                    q = np.trunc(np.clip(acc, 0, 255)).astype(np.uint8)  # (tile_p, 4)
                    for r in range(tile_p):
                        at = 16 * ((cg >> 2) ^ ((r >> 2) & mask)) + 4 * (cg & 3)
                        stage[r, at : at + 4] = q[r]
                rows = min(tile, oh - i * tile)
                cols = min(cb, ow - b * cb)
                for r in range(rows):
                    for c in range(cols):
                        at = 16 * ((c >> 4) ^ ((r >> 2) & mask)) + (c & 15)
                        out[p, i * tile + r, b * cb + c] = stage[r, at]
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


def expand_runs(first, taps, k):
    """The dense ``(n, size, k)`` rows of ``compact_runs``' form."""
    dense = np.zeros(first.shape + (k,), taps.dtype)
    np.put_along_axis(dense, first[..., None] + np.arange(taps.shape[-1]), taps, -1)
    return dense


def expand_windows(base, win, k):
    """The dense ``(n, size, k)`` rows of ``group_windows``' form."""
    n, groups, length, group = win.shape
    dense = np.zeros((n, groups, group, k), win.dtype)
    idx = (base[..., None] + np.arange(length))[:, :, None, :]
    np.put_along_axis(dense, idx, np.swapaxes(win, 2, 3), -1)
    return dense.reshape(n, groups * group, k)


SWEEP_SCALES = [(2, 1), (3, 1), (3, 2), (2, 3), (1, 2)]
SWEEP_EDGES = [
    {}, {"edge_mode": "reflect"}, {"edge_mode": "drop", "normalize": False},
    {"align": "center"},
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("kw", SWEEP_EDGES)
@pytest.mark.parametrize("scale", SWEEP_SCALES)
def test_compact_form_expands_to_the_dense_plan(scale, kw, precision):
    """Each output's (first tap, run of weights) and each group of four's
    shared window reproduce ``plan_weights``' dense matrices exactly (bf16:
    after the sum-keeping rounding), every index inside its band."""
    shape = (48, 66)
    cfg = ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    plan = rc.plan_at(cfg, 16, 24)
    assert plan is not None
    wv, wh = rc.plan_weights(plan, cfg.precision)
    first_v, taps_v, first_h, taps_h = rc.plan_runs(plan, cfg.precision)
    assert first_v.shape == wv.shape[:2] and first_h.shape == (wh.shape[0], plan.cb)
    assert first_v.min() >= 0 and (first_v + taps_v.shape[-1]).max() <= plan.kv
    assert first_h.min() >= 0 and (first_h + taps_h.shape[-1]).max() <= plan.kh
    np.testing.assert_array_equal(expand_runs(first_v, taps_v, plan.kv), wv)
    np.testing.assert_array_equal(
        np.swapaxes(expand_runs(first_h, taps_h, plan.kh), 1, 2), wh)
    # a run is no longer than the filter's taps at this scale
    n, d = scale
    assert max(taps_v.shape[-1], taps_h.shape[-1]) <= 2 * 3 * max(1, -(-d // n)) + 1
    lay = rc.kernel_layout(plan, cfg.precision)
    dense_v = expand_windows(lay["base_v"], np.swapaxes(lay["wv"], 1, 2), plan.kv)
    np.testing.assert_array_equal(dense_v[:, : plan.tile_out], wv)
    assert not dense_v[:, plan.tile_out :].any()
    dense_h = expand_windows(lay["base_h"], np.swapaxes(lay["wh"], 1, 2), plan.kh)
    np.testing.assert_array_equal(np.swapaxes(dense_h[:, : plan.cb], 1, 2), wh)
    assert not dense_h[:, plan.cb :].any()
    assert lay["win_v"] <= taps_v.shape[-1] + 3 * max(1, -(-d // n))


def test_compact_runs_of_a_scattered_matrix_only_grow():
    """A hand-built matrix whose nonzeros are not one narrow run still
    compacts exactly: the run spans first to last nonzero, and a row of
    zeros has an empty run at 0."""
    w = np.zeros((1, 4, 10), np.float32)
    w[0, 0, [1, 7]] = 0.5
    w[0, 1, 9] = 1.0
    w[0, 3, 0] = 1.0
    first, taps = rc.compact_runs(w)
    assert taps.shape == (1, 4, 7) and first.tolist() == [[1, 3, 0, 0]]
    np.testing.assert_array_equal(expand_runs(first, taps, 10), w)
    base, win = rc.group_windows(w)
    assert win.shape == (1, 1, 10, 4) and base.tolist() == [[0]]
    np.testing.assert_array_equal(expand_windows(base, win, 10), w)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw", [
    ((21, 37), (2, 1), {}),  # odd W; OW = 74, no multiple of 16
    ((18, 45), (3, 1), {"edge_mode": "reflect"}),  # OW = 135
    ((22, 50), (3, 2), {"align": "center"}),  # OW = 75
    ((12, 16), (2, 1), {}),  # one tile, one block
])
def test_plain_on_unaligned_widths_matches_tpu_gather(shape, scale, kw, precision):
    """Widths that break the kernel's 16-byte paths (the plain version has
    none, but walks the same compact form the byte paths feed)."""
    cfg = ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    plan = rc.fused_plan(cfg)
    img = _img(shape, seed=3)
    tpu_cfg = TpuConfig.from_profile("precise", shape, scale=scale, a=3, **kw)
    want = np.asarray(TpuUpscaler(tpu_cfg, backend="xla")(img))
    got = rc.fused_resample_reference(_planar(img), plan, precision, cfg.out_shape)
    _within(_interleaved(got), want, precision)
    lay = rc.kernel_layout(plan, cfg.precision)
    x = np.ascontiguousarray(img.transpose(2, 0, 1))
    emu = _emulate_kernel(x, lay, *cfg.out_shape, precision == "bf16")
    d = np.abs(emu.astype(np.int32) - got.numpy().astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


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
    # wv=: a shard's vertical tables (the JAX form, dense stacks, is refused)
    with pytest.raises(TypeError, match="VerticalTables"):
        rc.fused_call(ops, x, wv=(ops.plan.wv, ops.plan.wv))
    same = rc.vertical_tables(ops.plan, cfg.precision, "cpu")
    assert torch.equal(rc.fused_call(ops, x, wv=same), y)
    with pytest.raises(ValueError, match="have kv=13, the plan kv=20"):
        rc.fused_call(ops, x, wv=rc.vertical_tables(rc.plan_at(cfg, 16), cfg.precision, "cpu"))


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
