"""The v1 kernel (the port of ``_fused_kernel``) in its plain PyTorch
version, held to the JAX package's v1 kernel on the same seeded inputs.

- the plain version, on the port's own plan (``phase_plan``) and on the
  TPU kernel's numbers (``phase_plan_from_reference``), against
  ``PallasOps(cfg, interpret=True, variant="v1")``'s ``upscale_planar``:
  fp32 ≤ 1 LSB on ≤ 1% of pixels (only the order of a rational axis's sums
  differs: the TPU's dense hi/lo products, the port's taps; measured
  0–0.074%).  bf16 is held to the JAX *fp32* v1 under ≤ 3 LSB on ≤ 50%:
  the JAX bf16 v1 rounds each weight to nearest, the port keeping each
  phase's tap sum, so their bf16 bytes are not one result; and the JAX
  bf16 v1 is past that contract itself on center-aligned shapes (max 2 on
  56% of pixels against the fp32 gather at 30×40→45×60);
- the two plans' tables, floors and pad maps, equal;
- the CUDA kernel's host layout (tiles, per-tile band through the pad
  maps, masked stores, the bf16 intermediate) through a numpy re-enactment
  of its loops, byte for byte against the plain version;
- the tile choice at the full-width 1/16 thumbnail, where no fused plan
  fits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as TpuConfig  # noqa: E402
from lanczos_tpu.ops.resample_pallas import PallasOps  # noqa: E402
from lanczos_tpu.ops.resample_pallas import upscale_planar as tpu_upscale_planar  # noqa: E402

from lanczos_torch.core.config import ResampleConfig  # noqa: E402
from lanczos_torch.ops import _build  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.ops import resample_phase_cuda as rp  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}

# (in (h, w), out (h, w), overrides)
CASES = [
    ((24, 40), (36, 60), {}),  # 3/2
    ((36, 60), (24, 40), {}),  # 2/3
    ((48, 80), (24, 40), {}),  # 1/2, support 6
    ((256, 256), (16, 16), {}),  # 1/16, support 48
    ((24, 40), (48, 60), {}),  # mixed: 2/1 (integer) by 3/2
    ((24, 32), (24, 48), {}),  # 1/1 (integer) by 3/2
    ((24, 40), (36, 20), {}),  # anisotropic supports: 3/2 (3) by 1/2 (6)
    ((24, 40), (36, 60), {"edge_mode": "reflect"}),
    ((24, 40), (36, 60), {"edge_mode": "drop", "normalize": False}),
    ((30, 40), (45, 60), {"align": "center"}),
    ((25, 41), (37, 61), {}),  # ragged: N = 37 and 61 phases, no whole tiles
    ((32, 48), (2, 3), {"edge_mode": "reflect"}),  # reflect, support 48 > the image
]


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _diff(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def _cfgs(shape, out, kw, precision="fp32"):
    return (
        TpuConfig.from_profile("precise", shape, out_shape=out, a=3, **kw),
        ResampleConfig.from_profile("precise", shape, out_shape=out, a=3,
                                    precision=precision, **kw),
    )


def _jax_v1(tpu_cfg, x):
    pops = PallasOps(tpu_cfg, interpret=True, variant="v1")
    assert not pops.v2 and pops.mxu is None
    return pops, np.asarray(tpu_upscale_planar(x, pops))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,kw", CASES)
def test_plain_v1_matches_jax_v1(shape, out, kw, precision):
    tpu_cfg, cfg = _cfgs(shape, out, kw, precision)
    x = _noise((3,) + shape, seed=0)
    pops, want = _jax_v1(tpu_cfg, x)
    for plan in (rp.phase_plan(cfg), rp.phase_plan_from_reference(pops)):
        got = rp.phase_resample_reference(torch.from_numpy(x), plan, precision, out)
        assert got.shape == (3,) + out and got.dtype == torch.uint8
        mx, frac = _diff(got.numpy(), want)
        lim, frac_lim = LIMITS[precision]
        assert mx <= lim and frac <= frac_lim, (mx, frac)


@pytest.mark.parametrize("shape,out,kw", CASES)
def test_plan_from_reference_equals_the_ports_own(shape, out, kw):
    tpu_cfg, cfg = _cfgs(shape, out, kw)
    mine = rp.phase_plan(cfg)
    theirs = rp.phase_plan_from_reference(PallasOps(tpu_cfg, interpret=True, variant="v1"))
    for ax in ("v", "h"):
        a, b = getattr(mine, ax), getattr(theirs, ax)
        for k, v in vars(a).items():
            np.testing.assert_array_equal(v, getattr(b, k), err_msg=f"{ax}.{k}")
        assert a.tbl.dtype == np.float32 and a.pad.dtype == a.floors.dtype == np.int32


def test_batched_planar_through_fused_ops():
    tpu_cfg, cfg = _cfgs((24, 40), (36, 60), {})
    x = _noise((2, 3, 24, 40), seed=1)
    ops = rc.FusedOps(cfg, "cpu", variant="v1")
    assert (ops.variant, ops.kernel) == ("v1", "phase_resample_fp32")
    got = rc.upscale_planar(torch.from_numpy(x), ops)
    assert got.shape == (2, 3, 36, 60)
    _, want = _jax_v1(tpu_cfg, x)
    mx, frac = _diff(got.numpy(), want)
    assert mx <= 1 and frac <= 0.01, (mx, frac)
    # the interleaved entry point on one image agrees with the planar batch
    one = rc.resample_2d_cuda(torch.from_numpy(np.ascontiguousarray(x[1].transpose(1, 2, 0))), ops)
    assert torch.equal(one.permute(2, 0, 1), got[1])


def _tap_sum(w, v):
    """The kernel's sum in float32: multiply, then add, in tap order."""
    acc = np.float32(w[0]) * v[0]
    for t in range(1, len(w)):
        acc = acc + np.float32(w[t]) * v[t]
    return acc


def _emulate_v1(x, plan, out, precision, tr, tc):
    """The v1 kernel's loops in numpy: per (column tile, row tile, plane),
    the uint8 band its outputs read, through the pad maps; the vertical
    pass into the intermediate (rounded to bf16 where the config does);
    then the horizontal pass and a masked trunc-clip store."""
    (oh, ow), (nc, h, w) = out, x.shape
    (base_v, ph_v), (base_h, ph_h) = plan.v.taps(oh), plan.h.taps(ow)
    tv, th = plan.v.table(precision), plan.h.table(precision)
    taps_v, taps_h = 2 * plan.v.support, 2 * plan.h.support
    hp, wp = h + taps_v, w + taps_h
    ev_max, eh_max = rp._extent(base_v, tr, taps_v), rp._extent(base_h, tc, taps_h)
    res = np.full((nc, oh, ow), 7, np.uint8)  # stores must cover every pixel
    for p in range(nc):
        for y0 in range(0, oh, tr):
            for x0 in range(0, ow, tc):
                rows_n, cols_n = min(tr, oh - y0), min(tc, ow - x0)
                r0, c0 = base_v[y0], base_h[x0]
                ev = base_v[y0 + rows_n - 1] - r0 + taps_v
                eh = base_h[x0 + cols_n - 1] - c0 + taps_h
                assert ev <= ev_max and eh <= eh_max
                r, c = r0 + np.arange(ev), c0 + np.arange(eh)
                sr = np.where(r < hp, plan.v.pad[np.minimum(r, hp - 1)], -1)
                sc = np.where(c < wp, plan.h.pad[np.minimum(c, wp - 1)], -1)
                ok = (sr[:, None] >= 0) & (sc[None, :] >= 0)
                band = np.where(ok, x[p][np.maximum(sr, 0)[:, None], np.maximum(sc, 0)], 0)
                band = band.astype(np.uint8).astype(np.float32)
                mid = np.zeros((rows_n, eh), np.float32)
                for rr in range(rows_n):
                    y = y0 + rr
                    e0 = base_v[y] - r0
                    mid[rr] = _tap_sum(tv[ph_v[y]], band[e0 : e0 + taps_v])
                if plan.rounds_mid(precision):
                    mid = torch.from_numpy(mid).to(torch.bfloat16).float().numpy()
                for cc in range(cols_n):
                    xo = x0 + cc
                    f0 = base_h[xo] - c0
                    v = _tap_sum(th[ph_h[xo]], mid[:, f0 : f0 + taps_h].T)
                    res[p, y0 : y0 + rows_n, xo] = np.trunc(np.clip(v, 0, 255)).astype(np.uint8)
    return res


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,kw,tiles", [
    ((24, 40), (36, 60), {}, None),
    ((23, 37), (34, 55), {"align": "center", "edge_mode": "reflect"}, (8, 16)),  # ragged
    ((256, 256), (16, 16), {}, (4, 8)),  # 1/16: bands of 144 x 208
    ((20, 30), (40, 45), {"edge_mode": "drop", "normalize": False}, (16, 32)),  # 2/1 by 3/2
    ((24, 40), (48, 40), {}, (8, 16)),  # rational vertical by 1/1: fp32 intermediate in bf16
])
def test_v1_kernel_layout_reenacted(shape, out, kw, tiles, precision):
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=3,
                                      precision=precision, **kw)
    plan = rp.phase_plan(cfg)
    mid_bytes = 2 if plan.rounds_mid(precision) else 4
    if tiles is None:
        tiles = rp.kernel_tiles(plan, out, mid_bytes)[:2]
    x = _noise((2,) + shape, seed=2)
    got = _emulate_v1(x, plan, out, precision, *tiles)
    want = rp.phase_resample_reference(torch.from_numpy(x), plan, precision, out)
    np.testing.assert_array_equal(got, want.numpy())


def test_thumbnail_tiles_fit_shared_memory():
    """8K → 480×270 (1/16, support 48): no fused plan fits; the v1 block
    shrinks to 8×32 outputs with an fp32 intermediate and 16×32 with a
    bf16 one, and a 16×32 tile with an fp32 intermediate would not fit."""
    cfg = ResampleConfig((4320, 7680), (270, 480), a=3)
    assert rc.fused_plan(cfg) is None and rc.pallas_variant(cfg) == "v1"
    plan = rp.phase_plan(cfg)
    assert (plan.v.support, plan.h.support) == (48, 48)
    assert not plan.v.integer and not plan.h.integer
    assert rp.kernel_tiles(plan, (270, 480), 4) == (8, 32, 208, 592)
    assert rp.kernel_tiles(plan, (270, 480), 2) == (16, 32, 336, 592)
    assert rp.smem_bytes(336, 592, 16, 4) > _build.SMEM_LIMIT
    # the 3/2 upscale keeps the largest tile
    fsr = rp.phase_plan(ResampleConfig((1440, 2560), (2160, 3840), a=3))
    assert rp.kernel_tiles(fsr, (2160, 3840), 4)[:2] == (32, 128)


def test_phase_call_cpu_runs_plain_version_and_counts_no_launch():
    cfg = ResampleConfig.from_profile("precise", (24, 40), out_shape=(36, 60))
    ops = rc.FusedOps(cfg, "cpu", variant="v1")
    before = dict(rp.launches)
    x = torch.from_numpy(_noise((3, 24, 40), seed=3))
    y = rp.phase_call(ops.phase, x)
    assert y.shape == (3, 36, 60) and y.dtype == torch.uint8
    assert rp.launches == before
    with pytest.raises(ValueError, match="expected"):
        rp.phase_call(ops.phase, x[:, :23])
    with pytest.raises(ValueError, match="call upscale_planar"):
        rc.fused_call(ops, x)


@pytest.mark.parametrize("kw,kernel", [
    ({"precision": "bf16"}, "phase_resample_bf16"),
    ({}, "phase_resample_fp32"),
])
def test_kernel_names_the_intermediate(kw, kernel):
    """bf16 with a rational horizontal axis holds the intermediate in bf16;
    a rational vertical axis over an integer horizontal one keeps it fp32."""
    cfg = ResampleConfig.from_profile("precise", (24, 40), out_shape=(36, 60), **kw)
    assert rc.FusedOps(cfg, "cpu", variant="v1").kernel == kernel
    flat = ResampleConfig.from_profile("precise", (24, 40), out_shape=(36, 40), **kw)
    assert rc.FusedOps(flat, "cpu", variant="v1").kernel == "phase_resample_fp32"
