"""The sharded fused path of ``lanczos_torch.ShardedUpscaler`` on the CPU (the
kernel's plain version through ``fused_call(..., wv=)``) against the port's
single-device fused result and the JAX fused overlay
(``ShardedUpscaler(backend="mxu")``, the Pallas kernel in interpret mode),
at the eight cases of ``tests/test_sharded.py:151-165``.

Limits: identical bytes to the port's single-device fused result (each
shard's rows carry the frame's own weights in the same order), overlap
identical to the serial exchange; against the JAX result fp32 ≤ 1 LSB on
≤ 1% of pixels (the quantized intermediate ≤ 2), the port's bf16 ≤ 3 LSB
on ≤ 50% of the JAX fp32 result.
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.parallel.sharded import ShardedUpscaler as TpuSharded  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402
from lanczos_torch.parallel.sharded import ShardedUpscaler  # noqa: E402

INS = (64, 48)
CASES = {  # the reference's fused cases: out shape, overrides
    "2x": ((128, 96), {}),
    "3/2": ((96, 72), {}),
    "drop normalized": ((128, 96), dict(edge_mode="drop", normalize=True)),
    "dering": ((128, 96), dict(dering=True)),
    "drop dering": ((128, 96), dict(edge_mode="drop", normalize=False, dering=True)),
    "drop normalized dering": ((128, 96), dict(edge_mode="drop", normalize=True, dering=True)),
    "reflect": ((128, 96), dict(edge_mode="reflect")),
    "quantize": ((128, 96), dict(intermediate_quantize=True)),
}


def _cfg(name, precision="fp32"):
    outs, kw = CASES[name]
    return lanczos_torch.ResampleConfig.from_profile(
        "precise", INS, out_shape=outs, a=3, precision=precision, **kw)


def _img():
    return np.random.default_rng(42).integers(0, 256, size=(2, *INS, 3), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _tpu(name):
    outs, kw = CASES[name]
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", INS, out_shape=outs, a=3, **kw)
    sh = TpuSharded(tcfg, jax.make_mesh((2, 4), ("data", "rows")), backend="mxu")
    assert sh.use_mxu
    return np.asarray(sh(_img()))


def _within(got, want, lim, frac_lim):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= lim and (d > 0).mean() <= frac_lim, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_sharded_fused_equals_single_device_and_jax(name, precision):
    cfg = _cfg(name, precision)
    img = torch.from_numpy(_img())
    sh = ShardedUpscaler(cfg, Mesh.local(["cpu"] * 8, (2, 4)), backend="mxu")
    assert sh.use_mxu and len(sh._plans) == 4
    before = dict(rc.launches)
    got = sh(img)
    assert rc.launches == before  # the plain version: no kernel on the CPU
    single = lanczos_torch.Upscaler(cfg, device="cpu")
    assert single.path == "cuda" and single.plan is not None
    assert torch.equal(got, single(img))
    if precision == "bf16":
        _within(got.numpy(), _tpu(name), 3, 0.50)
    else:
        _within(got.numpy(), _tpu(name), 2 if cfg.intermediate_quantize else 1, 0.01)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 2), (1, 8)])
def test_fused_channel_groups_bit_identical(mesh_shape):
    """Two channel groups (overlap) give the serial exchange's bytes."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (64, 32), scale=(2, 1), a=3)
    img = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(mesh_shape[0], 64, 32, 3), dtype=np.uint8))
    mesh = Mesh.local(["cpu"] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    a = ShardedUpscaler(cfg, mesh, backend="mxu")(img)
    b = ShardedUpscaler(cfg, mesh, backend="mxu", overlap=False)(img)
    assert torch.equal(a, b)
    assert torch.equal(a, lanczos_torch.Upscaler(cfg, device="cpu")(img))
