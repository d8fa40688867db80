"""The gather path (``lanczos_torch.ops.resample_gather``, ``backend="xla"``)
on the CPU against ``lanczos_tpu``'s gather path on the same seeded inputs.

Limits: uint8 fp32 ≤ 1 LSB on ≤ 1% of pixels (the port takes each tap as a
multiply then an add in tap order and gives the JAX bytes; the margin is
for XLA's CPU FMA contraction), float32 output |Δ| ≤ 1e-3, uint16 ≤ 1
LSB on ≤ 1%; bf16 ≤ 3 LSB on ≤ 50% against the JAX *fp32* gather (the
port's bf16 sums in fp32; the JAX bf16 gather rounds every operation and
leaves its own contract on noise).  Gradients equal ``jax.grad``'s
(rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.ops import resample_xla as tpu_xla  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_gather as rg  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}

# (in (h, w), scale or out, overrides): edge modes, alignments, dering, the
# quantized intermediate, both pass orders, integer / rational / downscale
CASES = [
    ((24, 20), (2, 1), {}),
    ((24, 20), (3, 2), {}),
    ((30, 40), (1, 2), {}),
    ((24, 20), (2, 1), {"edge_mode": "drop", "normalize": False}),
    ((24, 20), (3, 2), {"edge_mode": "drop"}),
    ((24, 20), (2, 1), {"edge_mode": "reflect", "align": "center"}),
    ((30, 40), (3, 2), {"align": "center"}),
    ((24, 20), (2, 1), {"dering": True}),
    ((24, 20), (3, 2), {"dering": True, "order": "width_first"}),
    ((30, 40), (1, 2), {"dering": True, "edge_mode": "drop", "normalize": False}),
    ((24, 20), (2, 1), {"intermediate_quantize": True}),
    ((24, 20), (3, 2), {"intermediate_quantize": True, "order": "width_first",
                        "dering": True}),
    ((24, 20), (3, 1), {"order": "width_first", "edge_mode": "reflect"}),
]


def _img(shape, seed):
    """Gradients plus noise, like the JAX tests' ``small_img``."""
    rng = np.random.default_rng(seed)
    h, w = shape[-3], shape[-2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (yy + xx) * 255 // max(h + w - 2, 1)], axis=-1)
    noise = rng.integers(-40, 40, size=tuple(shape[:-1]) + (3,))
    return np.clip(base + noise, 0, 255).astype(np.uint8)[..., : shape[-1]]


def _cfgs(shape, scale, kw, precision="fp32"):
    args = dict(scale=scale, a=3, **kw)
    return (lanczos_torch.ResampleConfig.from_profile("precise", shape, precision=precision,
                                                      **args),
            lanczos_tpu.ResampleConfig.from_profile("precise", shape, **args))


def _within(got, want, precision):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    lim, frac_lim = LIMITS[precision]
    assert d.max() <= lim and (d > 0).mean() <= frac_lim, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("shape,scale,kw", CASES)
def test_uint8_matches_tpu_gather(shape, scale, kw):
    cfg, tcfg = _cfgs(shape, scale, kw)
    img = _img((2,) + shape + (3,), seed=1)  # a batch of two
    up = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")
    got = up(torch.from_numpy(img))
    assert up.path == "xla" and got.dtype == torch.uint8
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="xla")(img))
    _within(got.numpy(), want, "fp32")


@pytest.mark.parametrize("shape,scale,kw", CASES[:8])
def test_float32_matches_tpu_gather(shape, scale, kw):
    cfg, tcfg = _cfgs(shape, scale, kw)
    img = np.random.default_rng(2).random(shape + (3,), dtype=np.float32) * 255
    got = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(torch.from_numpy(img))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="xla")(img))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape,scale,kw", [CASES[0], CASES[1], CASES[5], CASES[7]])
def test_uint16_matches_tpu_gather(shape, scale, kw):
    cfg, tcfg = _cfgs(shape, scale, kw)
    img = np.random.default_rng(3).integers(0, 65536, shape + (3,), dtype=np.uint16)
    got = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(torch.from_numpy(img))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="xla")(img))
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


@pytest.mark.parametrize("shape,scale,kw", [CASES[0], CASES[1], CASES[2], CASES[6], CASES[7]])
def test_bf16_within_contract_of_tpu_fp32(shape, scale, kw):
    cfg, tcfg = _cfgs(shape, scale, kw, precision="bf16")
    img = _img(shape + (3,), seed=4)
    got = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(torch.from_numpy(img))
    want = np.asarray(lanczos_tpu.Upscaler(tcfg, backend="xla")(img))
    _within(got.numpy(), want, "bf16")
    # float input in bf16: bf16 out, as the JAX SeparableOps(cfg, bf16)
    f = img.astype(np.float32)
    y = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(torch.from_numpy(f))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("shape,scale,kw", [CASES[1], CASES[9], CASES[11]])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_tables_from_reference_give_the_same_result(shape, scale, kw, dtype):
    """The port on the JAX ``SeparableOps``' own tables, against eager
    ``resample_2d_xla`` on them: a mismatch is then an arithmetic fault,
    not a table fault."""
    cfg, tcfg = _cfgs(shape, scale, kw)
    tops = tpu_xla.SeparableOps(tcfg)
    ops = rg.SeparableOps.from_reference(
        cfg, {k: np.asarray(getattr(tops, k)) for k in ("idx_v", "w_v", "idx_h", "w_h")})
    own = rg.SeparableOps(cfg)
    for k in ("idx_v", "w_v", "idx_h", "w_h"):
        assert torch.equal(getattr(ops, k), getattr(own, k)), k
    img = _img(shape + (3,), seed=5).astype(dtype)
    got = rg.resample_2d_gather(torch.from_numpy(img), ops).numpy()
    want = np.asarray(tpu_xla.resample_2d_xla(jnp.asarray(img), tops))
    if dtype == np.uint8:
        _within(got, want, "fp32")
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_c_faithful_refused():
    cfg = lanczos_torch.ResampleConfig.from_profile("c_oracle", (16, 16), scale=(2, 1), a=2)
    with pytest.raises(NotImplementedError, match="CExactOps"):
        rg.resample_2d_gather(torch.zeros((16, 16, 3), dtype=torch.uint8), rg.SeparableOps(cfg))


def test_tables_on_another_device_refused():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 16), scale=(2, 1))
    with pytest.raises(ValueError, match="tables on cpu"):
        rg.resample_2d_gather(torch.zeros((16, 16, 3), device="meta"), rg.SeparableOps(cfg))


def test_grad_through_apply_banded_matches_jax():
    """As ``tests/test_autodiff.py``: the vjp of one banded pass."""
    from lanczos_tpu.core.config import EdgeMode
    from lanczos_tpu.core.weights import banded_weights

    op = banded_weights(12, 24, 2, "lanczos", EdgeMode.CLAMP, True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((12, 5)).astype(np.float32)
    g = rng.standard_normal((24, 5)).astype(np.float32)
    w = op.weights.astype(np.float32)

    _, vjp = jax.vjp(lambda v: tpu_xla.apply_banded(v, jnp.asarray(op.idx), jnp.asarray(w),
                                                    axis=0), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = rg.apply_banded(xt, torch.from_numpy(op.idx.astype(np.int64)), torch.from_numpy(w), 0)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"edge_mode": "reflect", "align": "center"}])
def test_grad_through_2d_resample_matches_jax(kw):
    """``torch.autograd.grad`` of a loss through the whole 2-D gather
    resample (float in, float out) against ``jax.grad`` on the same
    input, for the input and for the weights."""
    cfg, tcfg = _cfgs((8, 6), (3, 2), kw)
    tops = tpu_xla.SeparableOps(tcfg)
    x = np.random.default_rng(7).standard_normal((8, 6, 3)).astype(np.float32)

    def loss_jax(img, w_v):
        tops.w_v = w_v
        return jnp.sum(tpu_xla.resample_2d_xla(img, tops) ** 2)

    gx_want, gw_want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x), tops.w_v)
    ops = rg.SeparableOps(cfg)
    ops.w_v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (rg.resample_2d_gather(xt, ops) ** 2).sum()
    gx, gw = torch.autograd.grad(loss, (xt, ops.w_v))
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_want), rtol=1e-5, atol=1e-3)
