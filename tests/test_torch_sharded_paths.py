"""``lanczos_torch.ShardedUpscaler`` on the CPU against its own
single-device result and ``lanczos_tpu``'s ``ShardedUpscaler`` at the
scales, edge modes and ``c_oracle`` cases of ``tests/test_sharded.py``
(the limits of ``test_torch_sharded.py``: identical bytes to the port's
single-device path; fp32 ≤ 1 LSB on ≤ 1% of the JAX result, ``c_oracle``
identical bytes).
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.parallel.sharded import ShardedUpscaler as TpuSharded  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402
from lanczos_torch.parallel.sharded import ShardedUpscaler  # noqa: E402


def _mesh(shape):
    return Mesh.local(["cpu"] * (shape[0] * shape[1]), shape)


@functools.lru_cache(maxsize=None)
def _jax_mesh(shape):
    return jax.make_mesh(shape, ("data", "rows"))


def _cfgs(profile, ins, **kw):
    return (lanczos_torch.ResampleConfig.from_profile(profile, ins, **kw),
            lanczos_tpu.ResampleConfig.from_profile(profile, ins, **kw))


def _img(b, h, w, seed=42):
    return np.random.default_rng(seed).integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)


def _single(cfg, img, backend="xla"):
    return lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")(torch.from_numpy(img))


def _tpu(tcfg, shape, img):
    return np.asarray(TpuSharded(tcfg, _jax_mesh(shape))(img))


def _check_float(profile, ins, mesh_shape, img, **kw):
    cfg, tcfg = _cfgs(profile, ins, **kw)
    sh = ShardedUpscaler(cfg, _mesh(mesh_shape), backend="gather")
    got = sh(torch.from_numpy(img))
    assert torch.equal(got, _single(cfg, img))
    d = np.abs(got.numpy().astype(int) - _tpu(tcfg, mesh_shape, img).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    return sh


@pytest.mark.parametrize("scale", [(2, 1), (3, 1), (3, 2), (5, 4), (7, 2)])
@pytest.mark.parametrize("edge", ["clamp", "drop", "reflect"])
def test_sharded_scales_and_edges(scale, edge):
    n, d = scale
    ins = (8 * d * 4, 16 * d)
    img = _img(2, *ins)
    sh = _check_float("precise", ins, (2, 4), img, scale=scale, a=3, edge_mode=edge)
    assert sh.use_shift == (edge != "drop")


@pytest.mark.parametrize(
    "a,scale,hw,mesh_shape",
    [
        (2, (2, 1), (32, 24), (2, 4)),
        (3, (2, 1), (64, 32), (1, 4)),
        (2, (3, 2), (48, 24), (1, 4)),
        (3, (3, 1), (48, 32), (2, 2)),
    ],
)
def test_sharded_c_faithful_bit_exact(a, scale, hw, mesh_shape):
    """c_oracle over rows: identical to the port's single-device c_exact path
    and to the JAX sharded path (itself the oracle's bytes)."""
    cfg, tcfg = _cfgs("c_oracle", hw, scale=scale, a=a)
    imgs = _img(mesh_shape[0], *hw, seed=7)
    sh = ShardedUpscaler(cfg, _mesh(mesh_shape))
    out = sh(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(out, _single(cfg, imgs, "auto").numpy())
    np.testing.assert_array_equal(out, _tpu(tcfg, mesh_shape, imgs))
