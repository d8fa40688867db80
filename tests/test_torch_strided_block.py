"""The strided (``backend="shift_xla"``, ``ops/resample_strided``) and block
(``backend="block"``, ``ops/resample_block``) paths on the CPU against
``lanczos_tpu``'s ``resample_2d_shift_xla`` and ``resample_2d_block`` on
the same seeded inputs.

Limits: uint8 ≤ 1 LSB on ≤ 1% of pixels (strided takes each tap as a
multiply then an add, as the JAX path; block contracts in float64 where
the JAX path sums in fp32, in its einsum's order), float32 output |Δ| ≤
1e-3, bf16 ≤ 3 LSB on ≤ 50% against the JAX fp32 result.  Each path
refuses exactly the configs its JAX counterpart refuses.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.ops import resample_block_xla as tpu_block  # noqa: E402
from lanczos_tpu.ops import resample_shift_xla as tpu_shift  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_block as rb  # noqa: E402
from lanczos_torch.ops import resample_strided as rs  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}

# (in (h, w), scale, overrides) both paths take
CASES = [
    ((24, 20), (2, 1), {}),
    ((24, 20), (3, 2), {}),
    ((32, 40), (1, 2), {}),
    ((24, 20), (2, 1), {"edge_mode": "drop", "normalize": False}),
    ((24, 20), (3, 2), {"edge_mode": "reflect", "align": "center"}),
    ((24, 20), (2, 1), {"dering": True}),
    ((32, 48), (1, 16), {"edge_mode": "reflect"}),  # support 48 > the 32-row image
    ((24, 20), (4, 3), {"order": "width_first"}),
]
# configs only block takes (the strided path refuses them)
BLOCK_ONLY = [
    ((24, 20), (3, 2), {"edge_mode": "drop"}),  # drop + normalize
    ((24, 20), (2, 1), {"dering": True, "order": "width_first"}),
    ((24, 20), (2, 1), {"intermediate_quantize": True}),
    ((27, 21), (2, 3), {}),  # input dims not divisible by D
    ((34, 36), (35, 34), {}),  # N > 32
]
PATHS = {"shift_xla": (rs.StridedOps, rs.resample_2d_strided),
         "block": (rb.BlockOps, rb.resample_2d_block)}


def _img(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape[-3], shape[-2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (yy + xx) * 255 // max(h + w - 2, 1)], axis=-1)
    noise = rng.integers(-40, 40, size=tuple(shape[:-1]) + (3,))
    return np.clip(base + noise, 0, 255).astype(np.uint8)[..., : shape[-1]]


def _cfgs(shape, scale, kw, precision="fp32"):
    n, d = scale
    out = (-(-shape[0] * n // d), -(-shape[1] * n // d))
    args = dict(out_shape=out, a=3, **kw)
    return (lanczos_torch.ResampleConfig.from_profile("precise", shape, precision=precision,
                                                      **args),
            lanczos_tpu.ResampleConfig.from_profile("precise", shape, **args))


def _within(got, want, precision):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    lim, frac_lim = LIMITS[precision]
    assert d.max() <= lim and (d > 0).mean() <= frac_lim, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("backend,case", [("shift_xla", c) for c in CASES]
                         + [("block", c) for c in CASES + BLOCK_ONLY])
def test_uint8_matches_tpu(backend, case):
    shape, scale, kw = case
    cfg, tcfg = _cfgs(shape, scale, kw)
    img = _img((2,) + shape + (3,), seed=1)
    up = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")
    assert up.path == backend
    got = up(torch.from_numpy(img)).numpy()
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend=backend)(img))
    _within(got, want, "fp32")


@pytest.mark.parametrize("backend,case", list(itertools.product(PATHS, CASES[:6])))
def test_float32_matches_tpu(backend, case):
    shape, scale, kw = case
    cfg, tcfg = _cfgs(shape, scale, kw)
    img = np.random.default_rng(2).random(shape + (3,), dtype=np.float32) * 255
    got = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")(torch.from_numpy(img))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend=backend)(img))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("backend,case", list(itertools.product(PATHS, [CASES[0], CASES[1],
                                                                        CASES[4]])))
def test_bf16_within_contract_of_tpu_fp32(backend, case):
    shape, scale, kw = case
    cfg, tcfg = _cfgs(shape, scale, kw, precision="bf16")
    img = _img(shape + (3,), seed=3)
    got = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")(torch.from_numpy(img))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend=backend)(img))
    _within(got.numpy(), want, "bf16")


@pytest.mark.parametrize("case", [CASES[1], CASES[6]])
def test_strided_planar(case):
    """``channel_last=False`` on planar (B, C, H, W), and ``planar()``."""
    shape, scale, kw = case
    cfg, tcfg = _cfgs(shape, scale, kw)
    img = _img((2,) + shape + (3,), seed=4)
    planar = np.ascontiguousarray(np.transpose(img, (0, 3, 1, 2)))
    ops = rs.StridedOps(cfg)
    got = rs.resample_2d_strided(torch.from_numpy(planar), ops, channel_last=False)
    want = np.asarray(tpu_shift.resample_2d_shift_xla(
        jnp.asarray(planar), tpu_shift.ShiftOps(tcfg), channel_last=False))
    _within(got.numpy(), want, "fp32")
    up = lanczos_torch.Upscaler(cfg, backend="shift_xla", device="cpu")
    assert torch.equal(up.planar(torch.from_numpy(planar)), got)
    assert torch.equal(up(torch.from_numpy(img)).permute(0, 3, 1, 2), got)


@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[6]])
def test_strided_tables_from_reference(case):
    shape, scale, kw = case
    cfg, tcfg = _cfgs(shape, scale, kw)
    tops = tpu_shift.ShiftOps(tcfg)
    keys = ("nv", "dv", "nh", "dh", "sup_v", "sup_h", "tbl_v", "tbl_h", "off_v", "off_h",
            "pad_mode")
    ops = rs.StridedOps.from_reference(cfg, {k: getattr(tops, k) for k in keys})
    own = rs.StridedOps(cfg)
    for k in keys[:6] + ("off_v", "off_h", "pad_mode"):
        assert getattr(ops, k) == getattr(own, k), k
    for k in ("tbl_v", "tbl_h", "rows", "cols"):
        assert np.array_equal(np.asarray(getattr(ops, k)), np.asarray(getattr(own, k))), k
    img = _img(shape + (3,), seed=5)
    got = rs.resample_2d_strided(torch.from_numpy(img), ops).numpy()
    want = np.asarray(tpu_shift.resample_2d_shift_xla(jnp.asarray(img), tops))
    _within(got, want, "fp32")


@pytest.mark.parametrize("case", [CASES[1], BLOCK_ONLY[0], BLOCK_ONLY[4]])
def test_block_tables_from_reference(case):
    shape, scale, kw = case
    cfg, tcfg = _cfgs(shape, scale, kw)
    tops = tpu_block.BlockOps(tcfg)

    def fields(blk):
        return {k: np.asarray(getattr(blk, k)) for k in
                ("base", "T", "S", "n_tiles", "out_size", "weights64", "idx", "taps")}

    ops = rb.BlockOps.from_reference(cfg, fields(tops.blk_v), fields(tops.blk_h))
    own = rb.BlockOps(cfg)
    for blk, mine in ((ops.blk_v, own.blk_v), (ops.blk_h, own.blk_h)):
        assert (blk.base, blk.T, blk.S, blk.out_pad) == (mine.base, mine.T, mine.S, mine.out_pad)
        assert np.array_equal(blk.weights64, mine.weights64)
    img = _img(shape + (3,), seed=6)
    got = rb.resample_2d_block(torch.from_numpy(img), ops).numpy()
    want = np.asarray(tpu_block.resample_2d_block(jnp.asarray(img), tops))
    _within(got, want, "fp32")


_REFUSALS = list(itertools.product(
    ["precise", "hls", "c_oracle"],
    [(2, 1), (3, 2), (40, 1), (2, 3)],
    [{}, {"edge_mode": "drop"}, {"edge_mode": "drop", "normalize": False, "dering": True},
     {"intermediate_quantize": True}, {"dering": True, "order": "width_first"},
     {"order": "width_first"}],
))


@pytest.mark.parametrize("backend", list(PATHS))
def test_refusals_match_tpu(backend):
    """``NotImplementedError`` fires for exactly the configs the JAX
    ``ShiftOps`` / ``BlockOps`` refuse."""
    mk, _ = PATHS[backend]
    tmk = {"shift_xla": tpu_shift.ShiftOps, "block": tpu_block.BlockOps}[backend]
    seen = set()
    for profile, scale, kw in _REFUSALS:
        if profile != "precise" and kw:
            continue  # the bit-exact profiles fix edges, order and dering
        args = dict(scale=scale, a=2, **kw)
        shape = (22, 20)  # 22 is not divisible by 3
        try:
            cfg = lanczos_torch.ResampleConfig.from_profile(profile, shape, **args)
        except ValueError:
            continue
        tcfg = lanczos_tpu.ResampleConfig.from_profile(profile, shape, **args)
        try:
            tmk(tcfg)
            refused = False
        except NotImplementedError:
            refused = True
        if refused:
            with pytest.raises(NotImplementedError):
                mk(cfg)
        else:
            mk(cfg)
        seen.add(refused)
    assert seen == {True, False}
