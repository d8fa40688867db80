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
  re-enactment of the kernel's loops (each step one ``fmaf``), identical
  bytes to the plain version.

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
from test_torch_fma import fma32  # noqa: E402

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


def _swizzle(lin, on):
    """A byte of a TMA box in shared memory, 128-byte swizzled where ``on``:
    address bits 4-6 XOR bits 7-9 (``QuarterStage`` in the kernel)."""
    return lin ^ ((lin >> 3) & 0x70) if on else lin


def _emulate_kernel(x, lay, oh, ow, bf16, dering=False, quant=False, ring=False):
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
    staged tile (chunks swizzled by row group) and the masked store.  With
    ``ring``, the pipelined kernel's staging and store instead: row r of
    the tile into row r >> 2 of quarter r & 3 (128-byte swizzled where a
    block is 128 columns), each quarter out as a TMA box of ``tile / 4``
    rows by ``cb`` bytes to output rows 4k + q, clipped at the edges."""
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

    def window_sum(a, wts):  # a (steps, m), wts (steps, 4) -> (m, 4), in step order, fmaf
        acc = np.zeros((a.shape[1], 4), np.float32)
        for s in range(a.shape[0]):
            acc = fma32(acc, wts[s][None, :], a[s][:, None])
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
                swz = cb == 128
                quarters = np.zeros((4, -(-tile_p // 4 * cb // 1024) * 1024), np.uint8)
                for cg in range(cb_p // 4):
                    base = dj + lay["base_h"][u, cg]
                    assert base + win_h <= mw
                    acc = window_sum(midT[base : base + win_h], lay["wh"][u, :, cg])
                    if dering:
                        ch = dj + lay["ch"][u][:, 4 * cg : 4 * cg + 4]
                        acc = clamp(acc, midT[ch[0]].T, midT[ch[1]].T)
                    q = np.trunc(np.clip(acc, 0, 255)).astype(np.uint8)  # (tile_p, 4)
                    for r in range(tile_p):
                        if ring:
                            at = _swizzle((r >> 2) * cb + 4 * cg, swz)
                            quarters[r & 3, at : at + 4] = q[r]
                            continue
                        at = 16 * ((cg >> 2) ^ ((r >> 2) & mask)) + 4 * (cg & 3)
                        stage[r, at : at + 4] = q[r]
                if ring:
                    for qq in range(4):
                        for k in range(tile // 4):
                            row = 4 * (i * tile // 4 + k) + qq
                            for c in range(min(cb, ow - b * cb)):
                                if row < oh:
                                    out[p, row, b * cb + c] = quarters[qq, _swizzle(k * cb + c, swz)]
                    continue
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
    # the same taps in the same order, each rounded once: identical bytes
    np.testing.assert_array_equal(got, want.numpy())


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
    np.testing.assert_array_equal(got, want.numpy())  # one rounding a tap in both


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


# ---------------------------------------------------------------------------
# the pipelined kernel's host side: the path rule, the schedule, the ring
# ---------------------------------------------------------------------------


def _plan(cfg, tiles=None):
    return rc.fused_plan(cfg) if tiles is None else rc.plan_at(cfg, *tiles)


def _int_fields(cfg, tiles=None):
    lay = rc.kernel_layout(_plan(cfg, tiles), cfg.precision)
    return {k: v for k, v in lay.items() if isinstance(v, int)}


@pytest.mark.parametrize("shape,scale,kw,tiles,pointers,want", [
    ((2160, 3840), (2, 1), {}, None, (0, 256), (3, 3)),  # perf8k-batch4-oncard
    ((1440, 2560), (3, 2), {}, None, (0, 256), (3, 3)),  # quality4k-batch4-upscale
    ((2160, 3840), (2, 1), {"dering": True, "intermediate_quantize": True}, None, (0, 256), (3, 3)),
    ((256, 256), (2, 1), {"a": 2}, None, (0, 256), (4, 3)),  # fewer tiles than SMs
    ((512, 256), (1, 2), {"out_shape": (256, 256)}, None, (0, 256), (4, 1)),  # 1 block an SM
    ((2160, 3840), (2, 1), {}, None, (0, 8), (0, 0)),  # an unaligned pointer
    ((50, 77), (2, 1), {}, None, (0, 256), (0, 0)),  # W % 16 != 0
    ((40, 120), (3, 2), {}, None, (0, 256), (0, 0)),  # W = 120
    ((128, 512), (1, 2), {}, None, (0, 256), (0, 0)),  # a band 288 bytes wide
    ((40, 64), (2, 1), {}, (13, 20), (0, 256), (0, 0)),  # tile 13, block 16: no quarters
    ((96, 160), (3, 2), {}, (40, 96), (0, 256), (0, 0)),  # tile_p 40: base rows of 40 bytes
])
def test_ring_shape_rule(shape, scale, kw, tiles, pointers, want):
    """Which kernel a launch takes, and the ring's stages and blocks an SM,
    from the plan's geometry and the tensors' alignment alone."""
    kw = dict(kw)
    a = kw.pop("a", 3)
    size = {"out_shape": kw.pop("out_shape")} if "out_shape" in kw else {"scale": scale}
    cfg = ResampleConfig.from_profile("precise", shape, a=a, **size, **kw)
    f = _int_fields(cfg, tiles)
    (_, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    assert rc.ring_shape(f, w, oh, ow, pointers, cfg.dering) == want
    if max(pointers) % 16 == 0:  # host tables are aligned too: the layout's own route
        assert rc.upload_layout(_plan(cfg, tiles), cfg, "cpu").route == want


def test_ring_layout_and_what_does_not_fit():
    """The ring's shared memory at 4K->8K (the launcher's sum, by hand),
    and a band so large that two stages fit no block."""
    f = _int_fields(ResampleConfig.from_profile("precise", (2160, 3840), scale=(2, 1), a=3))
    # band 37 x 112, weights 4 (7 x 64 + 7 x 128), bases 64 + 128, to 128 bytes
    assert rc.ring_layout(f, False)["stage"] == 9728
    # 1024 to align; 8 quarters of 16 x 128 bytes; the intermediate 4 x 80 x 64; 4 x 20 of barriers
    assert rc.ring_layout(f, False)["fixed"] == 1024 + 8 * 2048 + 20480 + 80
    assert rc.ring_layout(f, True)["stage"] == 9728 + 8 * (64 + 128)
    big = dict(f, kv=256, bw=256, win_v=240, mw=240)
    assert rc.ring_shape(big, 3840, 4320, 7680, (0,), False) == (0, 0)


@pytest.mark.parametrize("nh,target,want", [
    (1, 128, 128), (2, 128, 128), (3, 128, 96), (4, 128, 128), (5, 128, 80), (7, 128, 112),
    (9, 128, 108), (3, 64, 48), (3, 32, 24), (37, 128, 128),
])
def test_block_width_prefers_whole_chunks(nh, target, want):
    """Blocks are multiples of lcm(N, 4), and of 16 where one fits."""
    assert rc._block_width(nh, target) == want


def _ring_runs(total, grid, num_tiles, n_cb):
    """The ring kernel's schedule re-enacted: block g takes the run
    [g·T/G, (g+1)·T/G) of (plane, column block, row tile), row tiles
    fastest (``tile_of``)."""
    runs = []
    for g in range(grid):
        run = []
        for t in range(g * total // grid, (g + 1) * total // grid):
            strip = t // num_tiles
            p = strip // n_cb
            run.append((p, strip - p * n_cb, t - strip * num_tiles))
        runs.append(run)
    return runs


@pytest.mark.parametrize("grid", [1, 7, 132, 264])
@pytest.mark.parametrize("planes,n_cb,num_tiles", [(1, 1, 3), (3, 4, 8), (3, 60, 68), (12, 5, 7)])
def test_ring_schedule_visits_every_tile_once(grid, planes, n_cb, num_tiles):
    total = planes * n_cb * num_tiles
    grid = min(total, grid)  # the launcher's grid: min(tiles, blocks an SM x SMs)
    runs = _ring_runs(total, grid, num_tiles, n_cb)
    seen = [t for run in runs for t in run]
    assert len(seen) == total and set(seen) == {
        (p, b, i) for p in range(planes) for b in range(n_cb) for i in range(num_tiles)}
    sizes = [len(run) for run in runs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for run in runs:  # down one column strip, then to the top of the next
        for (p0, b0, i0), (p1, b1, i1) in zip(run, run[1:]):
            assert (p1, b1, i1) == (p0, b0, i0 + 1) or (i0 == num_tiles - 1 and i1 == 0)


class _Barrier:
    """An mbarrier: a phase completes when its arrivals and its bytes are in."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phases = count, count, 0, 0

    def ready(self, parity):  # try_wait.parity: the phase of that parity has completed
        return (self.phases & 1) != parity

    def arrive(self, tx=0):
        self.pending, self.tx = self.pending - 1, self.tx + tx
        self._complete()

    def complete_tx(self, n):
        self.tx -= n
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phases, self.pending = self.phases + 1, self.count


def _run_ring(tiles, uniq, stages, seed):
    """The ring kernel's protocol re-enacted in one block, its steps in a
    random order: the producer thread (wait empty[s] at parity (n & 1) ^ 1,
    arrive with the bytes on full[s], the copies; a stage's horizontal
    tables only where it holds another block's), the copies landing later,
    the consumers (wait full[s] at parity n & 1, read the stage, wait until
    at most one store group reads staging, write staging buffer k & 1,
    arrive on empty[s], one store group) and the stores draining later.
    Returns the tiles in the order their stores left."""
    rng = np.random.default_rng(seed)
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(1) for _ in range(stages)]
    stage = [dict(tile=None, u=None) for _ in range(stages)]
    held = [-1] * stages
    loads, stores, done = [], [], []  # in flight: (stage, tile, u or None, bytes); (buffer, tile)
    prod = dict(k=0, s=0, n=0)
    cons = dict(k=0, s=0, n=0)
    while len(done) < len(tiles):
        moves = []
        if prod["k"] < len(tiles) and empty[prod["s"]].ready((prod["n"] & 1) ^ 1):
            moves.append("produce")
        if cons["k"] < len(tiles) and full[cons["s"]].ready(cons["n"] & 1) and len(stores) <= 1:
            moves.append("consume")
        moves += ["land"] * bool(loads) + ["drain"] * bool(stores)
        assert moves, "the ring deadlocked"
        move = moves[rng.integers(len(moves))]
        if move == "produce":
            s, k = prod["s"], prod["k"]
            u = uniq[tiles[k][1]]
            new_h = held[s] != u
            full[s].arrive(tx=2 + new_h)
            loads.append((s, k, u if new_h else None, 2 + new_h))
            held[s] = u
            prod.update(k=k + 1, s=(s + 1) % stages, n=prod["n"] + (s + 1 == stages))
        elif move == "land":
            s, k, u, n = loads.pop(rng.integers(len(loads)))
            stage[s]["tile"] = k
            if u is not None:
                stage[s]["u"] = u
            full[s].complete_tx(n)
        elif move == "consume":
            s, k = cons["s"], cons["k"]
            assert stage[s]["tile"] == k and stage[s]["u"] == uniq[tiles[k][1]]
            assert all(buf != k & 1 for buf, _ in stores), "staging overwritten while stored"
            empty[s].arrive()
            stores.append((k & 1, k))
            cons.update(k=k + 1, s=(s + 1) % stages, n=cons["n"] + (s + 1 == stages))
        else:
            done.append(stores.pop(0)[1])  # a thread's bulk groups complete in order
    return done


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(3))
def test_ring_protocol_reenacted(stages, seed):
    """Stage and phase arithmetic: no deadlock, every tile read from its own
    stage with its own column block's tables, no staging buffer written
    while its store reads it, every tile stored once, in order."""
    runs = _ring_runs(3 * 5 * 7, 4, 7, 5)
    uniq = [0, 1, 1, 1, 2]  # block -> unique horizontal tables, as at 2/1
    for run in runs:
        assert _run_ring(run, uniq, stages, seed) == list(range(len(run)))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw,tiles", [
    ((40, 128), (2, 1), {}, (64, 128)),  # 128-column blocks: swizzled quarters
    ((40, 128), (2, 1), {"dering": True}, (64, 128)),
    ((48, 96), (3, 2), {"align": "center"}, (64, 128)),  # 96 columns: plain quarters, ragged
    ((30, 96), (4, 3), {"intermediate_quantize": True}, (16, 128)),  # 4 rows a quarter
])
def test_ring_staging_reenacted(shape, scale, kw, tiles, precision):
    """The pipelined kernel's staged quarters and TMA stores, re-enacted on
    a plan it takes: identical bytes to the plain version."""
    cfg = ResampleConfig.from_profile("precise", shape, scale=scale, a=3, precision=precision,
                                      **kw)
    plan = rc.plan_at(cfg, *tiles)
    lay = rc.kernel_layout(plan, cfg.precision)
    (_, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    f = {k: v for k, v in lay.items() if isinstance(v, int)}
    assert rc.ring_shape(f, w, oh, ow, (0,), cfg.dering)[0] > 0
    x = _img(shape, seed=4).transpose(2, 0, 1).copy()
    got = _emulate_kernel(x, lay, oh, ow, precision == "bf16", cfg.dering,
                          cfg.intermediate_quantize, ring=True)
    want = rc.fused_resample_reference(torch.from_numpy(x), plan, precision, (oh, ow),
                                       cfg.dering, cfg.intermediate_quantize)
    np.testing.assert_array_equal(got, want.numpy())
