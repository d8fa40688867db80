"""Constant planes: every output of a plane of value v lies in [v − 1, v]
on the port's fused plain version, the port's ``backend="xla"`` and the
JAX ``Upscaler(backend="xla")`` alike, and dering gives exactly v.

The exact result is v; an fp32 sum of the taps lands a few ulps to either
side of it, and trunc-clip drops those below by a whole level.  Rounding
once a tap (``fmaf`` on the card, ``ops._fma.fma_sum`` in the plain
versions; XLA's CPU backend contracts the JAX tap chains into FMAs the
same way) keeps most values, and every value the reference's own
``tests/test_invariants.py`` holds (137 at 24×20, 2/1, a=3: see
``tests/test_torch_invariants.py``); a multiply and then an add, which the
port's plain versions took before, dropped 137 there on up to 75% of
pixels.  The fused kernel folds clamped edge taps into one weight, so its
edge rows and columns lose a level on more values than the gather's;
dering's clamp bounds are v itself.  Each test prints the share at v − 1
beside the JAX gather's.  ``lanczos_torch.tools.constant_planes`` counts
the values that lose a level on each kernel family, and its count over a
plane's distinct rows equals the plain version's over the whole plane."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from lanczos_tpu.core.config import ResampleConfig as JaxConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as JaxUpscaler  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402

VALUES = (1, 17, 100, 128, 200, 254, 255)
CONFIGS = [  # (in, scale, overrides)
    ((12, 10), (2, 1), {}),
    ((64, 96), (2, 1), {}),
    ((90, 130), (2, 1), {"align": "center"}),
    ((96, 160), (3, 2), {}),
    ((60, 80), (2, 1), {"dering": True}),
    ((72, 144), (7, 3), {}),
    ((80, 120), (5, 4), {"edge_mode": "reflect"}),
]
PATHS = ("fused plain version", "port xla")


def _jax_shares(in_shape, scale, kw) -> dict:
    cfg = JaxConfig.from_profile("precise", in_shape, scale=scale, a=3, **kw)
    up = JaxUpscaler(cfg, backend="xla")
    out = {}
    for v in VALUES:
        y = np.asarray(up(jnp.full((*in_shape, 3), v, jnp.uint8)))
        assert y.min() >= v - 1 and y.max() <= v, (v, y.min(), y.max())
        if kw.get("dering"):
            assert (y == v).all(), v
        out[v] = float((y == v - 1).mean())
    return out


@pytest.mark.parametrize("in_shape,scale,kw", CONFIGS,
                         ids=[f"{h}x{w}-{n}_{d}-{'-'.join(kw) or 'linear'}"
                              for (h, w), (n, d), kw in CONFIGS])
def test_constant_plane_in_v_minus_1_to_v(in_shape, scale, kw):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", in_shape, scale=scale, a=3, **kw)
    fused = rc.FusedOps(cfg, "cpu", variant="mxu")  # the fused kernel's plain version
    xla = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")
    run = {
        "fused plain version": lambda x: rc.resample_2d_cuda(x, fused),
        "port xla": xla,
    }
    jax_share = _jax_shares(in_shape, scale, kw)
    worst = dict.fromkeys(PATHS, 0.0)
    for v in VALUES:
        x = torch.full((*in_shape, 3), v, dtype=torch.uint8)
        shares = {}
        for path in PATHS:
            y = run[path](x).numpy()
            assert y.shape == (*cfg.out_shape, 3) and y.dtype == np.uint8
            assert y.min() >= v - 1 and y.max() <= v, (path, v, y.min(), y.max())
            if cfg.dering:
                assert (y == v).all(), (path, v)
            shares[path] = float((y == v - 1).mean())
            worst[path] = max(worst[path], shares[path])
        print(f"{in_shape} {scale} {kw} v={v}: share at v-1: "
              + ", ".join(f"{p} {s:.3f}" for p, s in shares.items())
              + f", JAX xla {jax_share[v]:.3f}")
    print(f"{in_shape} {scale} {kw} worst share at v-1: "
          + ", ".join(f"{p} {s:.3f}" for p, s in worst.items())
          + f", JAX xla {max(jax_share.values()):.3f}")


@pytest.mark.parametrize("in_shape,out_shape", [((24, 20), (48, 40)), ((24, 40), (36, 60))])
def test_constant_planes_tool_counts_equal_the_whole_planes(in_shape, out_shape):
    """The tool's count over each plane's distinct rows equals the plain
    version's over the whole plane, for each family that takes the
    config (kernel 2 integer scales only)."""
    from lanczos_torch.tools import constant_planes as cp

    cfg = lanczos_torch.ResampleConfig.from_profile("precise", in_shape, out_shape=out_shape, a=3)
    for family in cp.FAMILIES:
        if family == "kernel 2" and out_shape[0] % in_shape[0]:
            with pytest.raises(NotImplementedError):
                cp.family_ops(cfg, family, "cpu")
            continue
        ops = cp.family_ops(cfg, family, "cpu")
        assert cp.plane_losses(ops, "cpu") == cp.distinct_row_losses(ops), family
    assert cp.reference_137("cpu") == dict.fromkeys(cp.FAMILIES, 0.0)
