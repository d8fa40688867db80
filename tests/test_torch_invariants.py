"""The port against ``tests/test_invariants.py``: structural invariants of
the resampling operators, on the port's backends and on the plain
versions of its three kernel families, beside the JAX package on the same
seeded numpy inputs.

- a constant 137 plane at 24×20, 2/1, a=3 gives exactly 137 on every
  pixel (``xla``, ``shift_xla``, ``pallas``, ``auto``, and the fused
  kernel's, kernel 2's and v1's plain versions), as the JAX package's own
  backends do;
- every constant 0–255 at that config: each path's bytes equal a numpy
  chain that rounds each tap once (``fma32``) over that path's weights:
  the banded operator's for the gather, shift and phase paths, the fused
  plan's own (edge taps folded into one weight) for the fused kernel.  The
  JAX gather equals the same chain;
- transpose equivariance (≤ 1 LSB: the pass order swaps), identity scale,
  channel independence, 2-D gray and any channel count (identical bytes
  within the port, and to the JAX package where noted).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from lanczos_tpu.core.config import ResampleConfig as JaxConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as JaxUpscaler  # noqa: E402
from lanczos_tpu.models.upscaler import upscale as jax_upscale  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.core.weights import banded_weights  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.ops import resample_phase_cuda as rp  # noqa: E402
from test_torch_fma import fma32  # noqa: E402

IN, SCALE, A = (24, 20), (2, 1), 3  # tests/test_invariants.py:20-21


def _cfg(**kw):
    return lanczos_torch.ResampleConfig.from_profile("precise", IN, scale=SCALE, a=A, **kw)


def _planar(run):
    """A planar (NC, H, W) uint8 runner as an interleaved one."""
    return lambda x: run(torch.as_tensor(x).permute(2, 0, 1).contiguous()).permute(1, 2, 0)


def _paths(cfg) -> dict:
    """Every path a config can take on the CPU: the backends and the plain
    versions of the three kernel families (v1 both as chosen and with its
    generic design forced)."""
    paths = {b: lanczos_torch.Upscaler(cfg, backend=b, device="cpu")
             for b in ("xla", "shift_xla", "pallas", "auto")}
    for name, variant in (("fused", "mxu"), ("kernel 2", "v2")):
        ops = rc.FusedOps(cfg, "cpu", variant=variant)
        paths[name] = (lambda o: lambda x: rc.resample_2d_cuda(torch.as_tensor(x), o))(ops)
    for design in ("auto", "generic"):
        pops = rp.PhaseOps(cfg, "cpu", design=design)
        paths[f"v1 {pops.design}"] = _planar((lambda o: lambda x: rp.phase_call(o, x))(pops))
    return paths


def _np(y) -> np.ndarray:
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def test_constant_image_preserved_on_every_path():
    """``test_constant_image_preserved``: normalized weights and clamp edges
    reproduce a constant exactly, on the JAX package's backends and on
    every path of the port."""
    img = np.full((*IN, 3), 137, np.uint8)
    want = np.full((48, 40, 3), 137, np.uint8)
    jcfg = JaxConfig.from_profile("precise", IN, scale=SCALE, a=A)
    for b in ("xla", "shift_xla", "pallas"):
        np.testing.assert_array_equal(np.asarray(JaxUpscaler(jcfg, backend=b)(img)), want,
                                      err_msg=f"JAX {b}")
    paths = _paths(_cfg())
    assert set(paths) >= {"v1 window", "v1 generic"}
    for name, run in paths.items():
        y = _np(run(img))
        assert y.dtype == np.uint8
        np.testing.assert_array_equal(y, want, err_msg=name)


def _chain(x: np.ndarray, rows: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """``Σ_t w[o, t] · x[rows[o, t]]`` along ``axis`` in tap order, each tap
    rounded once."""
    acc = None
    for t in range(rows.shape[1]):
        xs = np.take(x, rows[:, t], axis=axis)
        wt = w[:, t].astype(np.float32).reshape([-1 if k == axis else 1 for k in range(x.ndim)])
        acc = (wt * xs).astype(np.float32) if acc is None else fma32(acc, wt, xs)
    return acc


def _banded_chain(x: np.ndarray, cfg) -> np.ndarray:
    ops = [banded_weights(i, o, cfg.a, cfg.filter, cfg.edge_mode, cfg.normalize,
                          align=cfg.align.value)
           for i, o in zip(cfg.in_shape, cfg.out_shape)]
    y = _chain(_chain(x, ops[0].idx, ops[0].weights, 0), ops[1].idx, ops[1].weights, 1)
    return np.trunc(np.clip(y, 0, 255)).astype(np.uint8)


def _fused_chain(x: np.ndarray, cfg) -> np.ndarray:
    """The chain over the fused plan's own rows: each output's band walked
    from its first to its last nonzero weight (folded edge taps are one
    weight), zero past the image."""
    plan = rc.fused_plan(cfg)
    (h, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    wv, wh = rc.plan_weights(plan, cfg.precision)

    def rows_of(dense, starts, size):  # (size, K) dense rows -> rows and weights
        first, taps = rc.compact_runs(dense[None])
        idx = starts[:, None] + first[0][:, None] + np.arange(taps.shape[-1])
        return idx[:size], taps[0][:size]

    starts_v = np.repeat(plan.starts_v, plan.tile_out)
    rv, tv = rows_of(wv.reshape(-1, plan.kv), starts_v, oh)
    wh_cols = np.swapaxes(wh, 1, 2)[plan.uniq_h].reshape(-1, plan.kh)
    rh, th = rows_of(wh_cols, np.repeat(plan.starts_h, plan.cb), ow)
    xz = np.zeros((max(h, rv.max() + 1), max(w, rh.max() + 1)) + x.shape[2:], np.float32)
    xz[:h, :w] = x
    mid = _chain(xz, rv, tv, 0)
    y = _chain(mid, rh, th, 1)
    return np.trunc(np.clip(y, 0, 255)).astype(np.uint8)


def test_every_constant_value_equals_a_one_rounding_chain():
    """All 256 constant planes at the reference's config: each path's bytes
    are a numpy chain of one rounding a tap over its own weights; the JAX
    gather gives the banded chain's bytes too.  Prints the count of values
    with any v − 1 pixel."""
    cfg = _cfg()
    jax_xla = JaxUpscaler(JaxConfig.from_profile("precise", IN, scale=SCALE, a=A), backend="xla")
    paths = _paths(cfg)
    counts = dict.fromkeys(list(paths) + ["JAX xla"], 0)
    for v in range(256):
        img = np.full((*IN, 1), v, np.uint8)
        banded = _banded_chain(img.astype(np.float32), cfg)
        fused = _fused_chain(img.astype(np.float32), cfg)
        outs = {name: _np(run(img)) for name, run in paths.items()}
        outs["JAX xla"] = np.asarray(jax_xla(jnp.asarray(img)))
        for name, y in outs.items():
            want = fused if name in ("fused", "pallas", "auto") else banded
            np.testing.assert_array_equal(y, want, err_msg=f"{name} v={v}")
            counts[name] += int((y != v).any())
    print("values of 256 with a pixel at v - 1:", counts)
    assert counts["xla"] == counts["JAX xla"] == 8  # the powers of two 1..128


@pytest.mark.parametrize("backend", ["xla", "shift_xla", "pallas"])
def test_transpose_equivariance(backend):
    """Transposing the image commutes with a resample whose axes share one
    scale, within 1 LSB (the pass order swaps); the port within 1 LSB of
    the JAX backend."""
    img = np.random.default_rng(42).integers(0, 256, size=(20, 20, 3), dtype=np.uint8)
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (20, 20), scale=(2, 1), a=2)
    m = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")
    a_ = m(np.swapaxes(img, 0, 1).copy()).numpy().astype(int)
    b_ = np.swapaxes(m(img).numpy(), 0, 1).astype(int)
    assert np.abs(a_ - b_).max() <= 1
    jcfg = JaxConfig.from_profile("precise", (20, 20), scale=(2, 1), a=2)
    theirs = np.asarray(JaxUpscaler(jcfg, backend=backend)(img)).astype(int)
    assert np.abs(np.swapaxes(b_, 0, 1) - theirs).max() <= 1


def test_identity_scale():
    """Scale 1/1 with normalized weights is the identity on every path."""
    img = np.random.default_rng(3).integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 16), scale=(1, 1), a=3)
    for name, run in _paths(cfg).items():
        np.testing.assert_array_equal(_np(run(img)), img, err_msg=name)


def test_channel_independence():
    """Channels resample independently, as in the JAX package."""
    img = np.random.default_rng(42).integers(0, 256, size=(16, 12, 3), dtype=np.uint8)
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 12), scale=(2, 1), a=2)
    for backend in ("xla", "auto"):
        m = lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")
        full = m(img).numpy()
        for c in range(3):
            mono = np.repeat(img[..., c : c + 1], 3, axis=-1)
            np.testing.assert_array_equal(m(mono).numpy()[..., 0], full[..., c])


def test_channel_counts_and_2d_gray():
    """Any channel count, and a bare 2-D image as one gray channel returned
    2-D, through ``lanczos_torch.upscale``; within 1 LSB of the JAX
    ``upscale`` on the same image."""
    base = np.random.default_rng(42).integers(0, 256, size=(32, 24, 4), dtype=np.uint8)
    for c in (1, 2, 4):
        out = lanczos_torch.upscale(base[..., :c], scale=(2, 1), a=2, device="cpu").numpy()
        assert out.shape == (64, 48, c)
        solo = lanczos_torch.upscale(base[..., c - 1 : c], scale=(2, 1), a=2, device="cpu")
        np.testing.assert_array_equal(out[..., -1:], solo.numpy())
        theirs = np.asarray(jax_upscale(base[..., :c], scale=(2, 1), a=2)).astype(int)
        assert np.abs(out.astype(int) - theirs).max() <= 1
    gray = lanczos_torch.upscale(base[..., 0], scale=(2, 1), a=2, device="cpu").numpy()
    assert gray.shape == (64, 48)
    one = lanczos_torch.upscale(base[..., :1], scale=(2, 1), a=2, device="cpu").numpy()
    np.testing.assert_array_equal(gray, one[..., 0])
