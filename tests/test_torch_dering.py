"""The fused kernel's nonlinear variants (the FSR dering clamp, the
uint8-quantized intermediate, both, and their width-first configs) in
their plain PyTorch version, held to the JAX package on the same seeded
inputs:

- the plain version on the JAX kernel's own dering plan
  (``plan_from_reference``) against ``PallasOps(..., variant="mxu")`` in
  interpret mode, at the JAX tests' shapes (``tests/test_pallas.py``);
- the port's own plan through ``lanczos_torch.upscale(..., device="cpu")``
  against the JAX gather path ``Upscaler(cfg, "xla")``.

Limits (``hwcert.py``'s contract, against the exact or fp32 result):
fp32 ≤ 1 LSB on ≤ 1% of pixels, quantized fp32 ≤ 2 LSB on ≤ 1% (one
flipped intermediate spreads over the taps, ``resample_pallas.py:935``),
bf16 ≤ 3 LSB on ≤ 50%.  ``hwcert.py``'s 5% cap for bf16 dering compares
against the bf16 gather, not the exact result, and is not used here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as TpuConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as TpuUpscaler  # noqa: E402
from lanczos_tpu.ops.resample_pallas import (  # noqa: E402
    PallasOps,
    resample_2d_pallas,
    upscale_planar as tpu_upscale_planar,
)

import lanczos_torch  # noqa: E402
from lanczos_torch.core.config import ResampleConfig  # noqa: E402
from lanczos_torch.core.weights import BandedOperator  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402

# (in (h, w), scale, overrides): the JAX tests' nonlinear cases
CASES = [
    ((60, 80), (2, 1), {"dering": True}),  # test_pallas.py:222-244
    ((60, 80), (3, 1), {"dering": True, "edge_mode": "reflect"}),
    ((60, 80), (3, 2), {"dering": True}),
    ((48, 64), (3, 2), {"dering": True, "edge_mode": "drop", "normalize": False}),  # :263
    ((48, 64), (3, 2), {"dering": True, "edge_mode": "drop"}),
    ((48, 64), (2, 1), {"intermediate_quantize": True}),  # :289-321
    ((48, 64), (2, 1), {"intermediate_quantize": True, "order": "width_first"}),
    ((40, 56), (3, 2), {"dering": True, "order": "width_first"}),  # :324-344
    ((48, 64), (2, 1), {"dering": True, "intermediate_quantize": True}),
    ((50, 70), (3, 2), {"dering": True, "align": "center"}),  # ragged tile and block
]


def _limits(precision, kw):
    if precision == "bf16":
        return 3, 0.50
    return (2 if kw.get("intermediate_quantize") else 1), 0.01


def _within(got, want, precision, kw):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    lim, frac_lim = _limits(precision, kw)
    assert d.max() <= lim and (d > 0).mean() <= frac_lim, (d.max(), (d > 0).mean())


def _noise(shape, seed):
    """Uniform noise, as the JAX tests of these paths draw it: every pixel
    a possible ringing edge, so both clamps are busy."""
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _tpu_gather(img, **kw):
    cfg = TpuConfig.from_profile("precise", img.shape[:2], **kw)
    return TpuUpscaler(cfg, backend="xla")(img)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw", CASES)
def test_plain_on_tpu_plan_matches_pallas_mxu(shape, scale, kw, precision):
    """The port's plain version on exactly the TPU kernel's matrices and
    bound selectors, against that kernel in interpret mode (its fp32
    hi/lo split, for both of the port's precisions)."""
    tpu_cfg = TpuConfig.from_profile("precise", shape, scale=scale, a=3, **kw)
    pops = PallasOps(tpu_cfg, interpret=True, variant="mxu", tile_h=16)
    img = _noise(shape + (3,), seed=7)
    want = np.asarray(resample_2d_pallas(img, pops))
    plan = rc.plan_from_reference(vars(pops.mxu))
    assert (plan.center_v is not None) == bool(kw.get("dering"))
    cfg = ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    ops = rc.FusedOps(cfg, "cpu", plan=plan)
    got = rc.resample_2d_cuda(torch.from_numpy(img), ops)
    _within(got.numpy(), want, precision, kw)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw", CASES)
def test_upscale_matches_tpu_gather(shape, scale, kw, precision):
    """The slice as a user calls it, on the port's own plan, against the
    JAX gather path in fp32 (its bf16 mode rounds more often than the
    fused kernels and is no reference for them)."""
    img = _noise(shape + (3,), seed=8)
    got = lanczos_torch.upscale(
        img, scale=scale, a=3, precision=precision, device="cpu", **kw
    )
    assert got.device.type == "cpu"
    tpu_cfg = TpuConfig.from_profile("precise", shape, scale=scale, a=3, **kw)
    want = np.asarray(TpuUpscaler(tpu_cfg, backend="xla")(img))
    _within(got.numpy(), want, precision, kw)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw", [
    ((21, 37), (2, 1), {"dering": True}),  # odd W, OW = 74
    ((18, 45), (3, 1), {"dering": True, "edge_mode": "reflect"}),  # OW = 135
    ((22, 50), (3, 2), {"dering": True, "intermediate_quantize": True}),  # OW = 75
    ((21, 37), (2, 1), {"intermediate_quantize": True}),
    ((12, 16), (2, 1), {"dering": True}),  # one tile, one block
    ((37, 21), (2, 1), {"dering": True, "order": "width_first"}),  # odd after the transpose
])
def test_unaligned_widths_match_tpu_gather(shape, scale, kw, precision):
    """Widths that are no multiple of 16 (the kernel's byte paths), through
    the compact form's tap-order sums, against the JAX gather path."""
    img = _noise(shape + (3,), seed=12)
    got = lanczos_torch.upscale(
        img, scale=scale, a=3, precision=precision, device="cpu", **kw
    )
    want = np.asarray(_tpu_gather(img, scale=scale, a=3, **kw))
    _within(got.numpy(), want, precision, kw)


@pytest.mark.parametrize("shape,scale,kw", [
    ((60, 80), (2, 1), {"dering": True}),
    ((48, 64), (3, 2), {"dering": True, "edge_mode": "drop", "normalize": False}),
    ((50, 70), (3, 2), {"dering": True, "align": "center"}),
])
def test_central_taps_lie_inside_each_outputs_run(shape, scale, kw):
    """The clamp's two central taps are taps of the compact run wherever
    their weights are nonzero, so the bounds the kernel reads come from
    the band rows and intermediate columns its sums already touch."""
    cfg = ResampleConfig.from_profile("precise", shape, scale=scale, a=3, **kw)
    plan = rc.fused_plan(cfg)
    first_v, taps_v, first_h, taps_h = rc.plan_runs(plan, cfg.precision)
    wv, wh = rc.plan_weights(plan, cfg.precision)
    for first, taps, center, dense in (
        (first_v, taps_v, plan.center_v, wv),
        (first_h, taps_h, plan.center_h, np.swapaxes(wh, 1, 2)),
    ):
        n = np.arange(dense.shape[0])[:, None, None]
        r = np.arange(dense.shape[1])[None, None, :]
        weight = dense[n, r, center]  # (n, 2, size)
        inside = (center >= first[:, None]) & (center < first[:, None] + taps.shape[-1])
        assert inside[weight != 0].all()


def test_pass_order_shows_through_the_nonlinearity():
    """Width-first and height-first differ through the quantize, so the
    transposed kernel is load-bearing; the port follows the JAX package
    on both orders."""
    img = _noise((48, 64, 3), seed=9)
    outs = {}
    for order in ("height_first", "width_first"):
        kw = dict(scale=(2, 1), a=3, intermediate_quantize=True, order=order)
        outs[order] = lanczos_torch.upscale(img, device="cpu", **kw).numpy()
        want = np.asarray(_tpu_gather(img, **kw))
        _within(outs[order], want, "fp32", kw)
    assert not np.array_equal(outs["height_first"], outs["width_first"])


def test_width_first_batched_planar_matches_tpu():
    """Batched planar input through the transposed kernel equals the
    interleaved call, and the JAX package's planar call."""
    shape = (40, 56)
    cfg = ResampleConfig.from_profile(
        "precise", shape, scale=(3, 2), a=3, dering=True, order="width_first"
    )
    ops = rc.FusedOps(cfg, "cpu")
    assert ops.tr_ops is not None and ops.plan is ops.tr_ops.plan
    assert ops.tr_ops.cfg.in_shape == (56, 40) and ops.tr_ops.cfg.order.value == "height_first"
    batch = np.stack([_noise(shape + (3,), 10), _noise(shape + (3,), 11)])
    planar = np.ascontiguousarray(np.transpose(batch, (0, 3, 1, 2)))
    got = rc.upscale_planar(torch.from_numpy(planar), ops)
    assert got.shape == (2, 3, 60, 84)
    inter = rc.resample_2d_cuda(torch.from_numpy(batch), ops)
    assert torch.equal(inter.permute(0, 3, 1, 2), got)
    tpu_cfg = TpuConfig.from_profile(
        "precise", shape, scale=(3, 2), a=3, dering=True, order="width_first"
    )
    want = np.asarray(tpu_upscale_planar(planar, PallasOps(tpu_cfg, interpret=True,
                                                           variant="mxu")))
    _within(got.numpy(), want, "fp32", {})


def test_blocks_with_other_central_taps_do_not_share_a_matrix():
    """Two column blocks whose dense matrices are equal but whose central
    taps differ (a zero weight on a tap that moves) must keep one matrix
    each: the offsets are part of the dedup key."""
    iw, ow, cb = 64, 128, 32
    y = np.arange(ow)
    base = y // 2
    idx = np.stack([base, np.minimum(base + 1, iw - 1)], axis=1).astype(np.int32)
    # block 1's second tap points elsewhere, under a zero weight
    idx[cb : 2 * cb, 1] = np.minimum(base[cb : 2 * cb] + 2, iw - 1)
    w = np.stack([np.ones(ow), np.zeros(ow)], axis=1)
    op_h = BandedOperator(iw, ow, 1, idx, w, base.astype(np.int32))
    op_v = BandedOperator(8, 8, 1, np.stack([np.arange(8)] * 2, 1).astype(np.int32),
                          np.stack([np.ones(8), np.zeros(8)], 1), np.arange(8, dtype=np.int32))
    cfg = ResampleConfig((8, iw), (8, ow), a=1, dering=True)
    plan = rc.build_fused_plan(cfg, 8, op_v, op_h, 1, 1, 0, cb)
    assert np.array_equal(plan.wh[plan.uniq_h[0]], plan.wh[plan.uniq_h[1]])
    assert plan.uniq_h[0] != plan.uniq_h[1]
    assert not np.array_equal(plan.center_h[plan.uniq_h[0]], plan.center_h[plan.uniq_h[1]])
    linear = rc.build_fused_plan(
        ResampleConfig((8, iw), (8, ow), a=1), 8, op_v, op_h, 1, 1, 0, cb
    )
    assert linear.uniq_h[0] == linear.uniq_h[1] and linear.center_h is None


def test_4k_dering_plan_fits_one_block():
    """At 4K→8K the dering plan is the linear plan plus offsets: the same
    64-row tiles and 128-column blocks and three unique horizontal
    matrices.  A block holds a 37×112-byte band, an 80×64 fp32
    intermediate, a 64×128-byte staged tile and its tables (7-step windows
    of 16 row groups and 32 column groups, and their bases); the dering
    plan adds its offsets (2×64 and 2×128 int32)."""
    lin = ResampleConfig.from_profile("precise", (2160, 3840), scale=(2, 1), a=3)
    der = ResampleConfig.from_profile("precise", (2160, 3840), scale=(2, 1), a=3,
                                      dering=True)
    p, q = rc.fused_plan(lin), rc.fused_plan(der)
    assert (q.tile_out, q.cb, q.kv, q.kh, q.wh.shape[0]) == (64, 128, 37, 69, 3)
    tables = 16 * 7 * (16 + 32) + 4 * (16 + 32)
    assert p.smem_bytes() == 37 * 112 + 4 * 80 * 64 + 64 * 128 + tables < 48 * 1024
    assert q.smem_bytes() == p.smem_bytes() + 4 * 2 * (64 + 128) < 48 * 1024
    assert q.center_v.shape == (68, 2, 64) and q.center_h.shape == (3, 2, 128)


def test_dering_plan_is_checked():
    cfg = ResampleConfig.from_profile("precise", (20, 30), scale=(2, 1), dering=True)
    plan = rc.fused_plan(cfg)
    lin = rc.fused_plan(ResampleConfig.from_profile("precise", (20, 30), scale=(2, 1)))
    with pytest.raises(ValueError, match="plan does not fit"):
        rc.FusedOps(cfg, "cpu", plan=lin)  # no offsets
    bad = rc.FusedPlan(**{**vars(plan), "center_v": plan.center_v + plan.kv})
    with pytest.raises(ValueError, match="plan does not fit"):
        rc.FusedOps(cfg, "cpu", plan=bad)
    x = torch.zeros((3, 20, 30), dtype=torch.uint8)
    with pytest.raises(ValueError, match="central-tap offsets"):
        rc.fused_resample_reference(x, lin, "fp32", (40, 60), dering=True)
