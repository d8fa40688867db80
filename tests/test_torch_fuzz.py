"""The port against ``tests/test_fuzz.py``: seeded configs drawn as the JAX
package draws them (filters, edges, alignment, dering, scales), through
every path of the port, beside the JAX package on the same numpy inputs.

- ``test_backends_agree_random_config``: the 24 draws of
  ``test_fuzz.py:39-54`` through the port's ``xla``, ``shift_xla``,
  ``block``, ``pallas`` and ``auto``, each within 1 LSB of the JAX gather
  (a backend that refuses a config is skipped, as there);
- ``test_fused_plain_version_random_config``: the fused kernel's plain
  version on the 12 draws of ``:82-98``, within 1 LSB of the JAX gather;
- ``test_execution_modes_agree_random_config``: the draws of ``:57-90``
  (seeds 0–7 as drawn there; seeds 8–15 drawn alike, with the filter and
  dering varied) through ``ShardedUpscaler`` on
  ``Mesh.local(["cpu"] * 4, (1, 4))`` and ``StreamingUpscaler``, identical
  bytes to the port's whole frame (the gather chunk and shard paths to its
  gather, the fused shard path to its fused kernel's plain version; the
  fused chunk path within 1 LSB of it, the reference's contract for
  chunks, ``tests/test_streaming.py:76-87``), and the JAX package's halo
  refusal where the JAX package refuses;
- ``test_sharded_overlap_matches_serial_random_config``: the draws of
  ``:112-140``, overlap on and off identical bytes on ``gather`` and
  ``auto``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from lanczos_tpu.core.config import ResampleConfig as JaxConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as JaxUpscaler  # noqa: E402
from lanczos_tpu.parallel.sharded import ShardedUpscaler as JaxSharded  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402
from lanczos_torch.parallel.sharded import ShardedUpscaler  # noqa: E402
from test_fuzz import _random_cfg as jax_random_cfg  # noqa: E402

SCALES = [(2, 1), (3, 1), (4, 1), (3, 2), (5, 4), (5, 2), (1, 2), (2, 3), (7, 3)]
EDGES = ["clamp", "drop", "reflect"]
FILTERS = ["lanczos", "mitchell", "catmull_rom", "triangle"]
BACKENDS = ("xla", "shift_xla", "block", "pallas", "auto")


def _random_kw(rng) -> dict:
    """``test_fuzz._random_cfg``'s draw, call for call, as config keywords."""
    n, d = SCALES[rng.integers(len(SCALES))]
    h = int(rng.integers(2, 7)) * d * 2
    w = int(rng.integers(2, 7)) * d * 2
    a = int(rng.integers(2, 4))
    edge = EDGES[rng.integers(len(EDGES))]
    align = "center" if rng.integers(2) else "zero"
    dering = bool(rng.integers(2))
    filt = FILTERS[rng.integers(len(FILTERS))]
    return dict(in_shape=(h, w), scale=(n, d), a=a, edge_mode=edge, align=align,
                dering=dering, filter=filt, normalize=edge != "drop")


def _cfgs(kw: dict):
    kw = dict(kw)
    ins = kw.pop("in_shape")
    return (lanczos_torch.ResampleConfig.from_profile("precise", ins, **kw),
            JaxConfig.from_profile("precise", ins, **kw))


def _max_diff(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("seed", range(24))
def test_backends_agree_random_config(seed):
    rng = np.random.default_rng(1000 + seed)
    kw = _random_kw(rng)
    assert _cfgs(kw)[1] == jax_random_cfg(np.random.default_rng(1000 + seed))
    cfg, jcfg = _cfgs(kw)
    img = rng.integers(0, 256, size=(*cfg.in_shape, 3), dtype=np.uint8)
    ref = np.asarray(JaxUpscaler(jcfg, backend="xla")(img))
    assert ref.shape == (*cfg.out_shape, 3)
    ran = []
    for b in BACKENDS:
        try:
            out = lanczos_torch.Upscaler(cfg, backend=b, device="cpu")(img).numpy()
        except (NotImplementedError, ValueError):
            assert b != "xla"
            continue  # the backend refuses this config, as the JAX one may
        assert _max_diff(out, ref) <= 1, f"seed {seed} backend {b} cfg {cfg}"
        ran.append(b)
    assert "xla" in ran and "auto" in ran


@pytest.mark.parametrize("seed", range(12))
def test_fused_plain_version_random_config(seed):
    rng = np.random.default_rng(7000 + seed)
    cfg, jcfg = _cfgs(_random_kw(rng))
    img = rng.integers(0, 256, size=(*cfg.in_shape, 3), dtype=np.uint8)
    try:
        ops = rc.FusedOps(cfg, "cpu", variant="mxu")
    except NotImplementedError:
        return  # no plan fits, as the JAX test's PallasOps may find
    out = rc.resample_2d_cuda(torch.from_numpy(img), ops).numpy()
    ref = np.asarray(JaxUpscaler(jcfg, backend="xla")(img))
    assert _max_diff(out, ref) <= 1, f"seed {seed} cfg {cfg}"


def _modes_kw(seed: int) -> tuple:
    """``test_fuzz.py:65-82``'s draw from ``default_rng(2000 + seed)``; from
    seed 8 on (past the JAX test's 8) the filter and dering vary too."""
    rng = np.random.default_rng(2000 + seed)
    n, d = SCALES[rng.integers(len(SCALES))]
    h = int(rng.integers(2, 5)) * d * n * 4
    w = int(rng.integers(2, 5)) * d * 2
    a = int(rng.integers(2, 4))
    align = "center" if rng.integers(2) else "zero"
    edge = EDGES[rng.integers(len(EDGES))]
    kw = dict(in_shape=(h, w), scale=(n, d), a=a, align=align, edge_mode=edge,
              normalize=edge != "drop")
    if seed >= 8:
        kw.update(filter=FILTERS[seed % 4], dering=bool(seed % 2) and edge != "drop")
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    chunk = int(rng.integers(1, 4)) * n * 2
    return kw, img, chunk


@pytest.mark.parametrize("seed", range(16))
def test_execution_modes_agree_random_config(seed):
    kw, img, chunk = _modes_kw(seed)
    cfg, jcfg = _cfgs(kw)
    xla = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(img).numpy()
    assert _max_diff(xla, np.asarray(JaxUpscaler(jcfg, backend="xla")(img))) <= 1
    mesh = Mesh.local(["cpu"] * 4, (1, 4))
    try:
        JaxSharded(jcfg, jax.make_mesh((1, 4), ("data", "rows")))
    except ValueError as e:  # the JAX package refuses: so must the port
        assert "halo" in str(e)
        for backend in ("gather", "auto"):
            with pytest.raises(ValueError, match="halo"):
                ShardedUpscaler(cfg, mesh, backend=backend)
    else:
        got = ShardedUpscaler(cfg, mesh, backend="gather")(img[None]).numpy()[0]
        np.testing.assert_array_equal(got, xla, err_msg=f"sharded gather seed {seed}")
        auto = ShardedUpscaler(cfg, mesh)
        whole = (lanczos_torch.Upscaler(cfg, backend="auto", device="cpu")(img).numpy()
                 if auto.use_mxu else xla)
        np.testing.assert_array_equal(auto(img[None]).numpy()[0], whole,
                                      err_msg=f"sharded auto seed {seed}")
    streamed = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, chunk_backend="gather",
                                               device="cpu")(img)
    np.testing.assert_array_equal(streamed, xla, err_msg=f"stream gather seed {seed}")
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, device="cpu")
    out = sm(img)
    if sm.chunk_path == "fused":
        whole = lanczos_torch.Upscaler(cfg, backend="auto", device="cpu")(img).numpy()
        assert _max_diff(out, whole) <= 1, f"stream fused seed {seed}"
    else:
        np.testing.assert_array_equal(out, xla, err_msg=f"stream {sm.chunk_path} seed {seed}")


@pytest.mark.parametrize("seed", range(8))
def test_sharded_overlap_matches_serial_random_config(seed):
    rng = np.random.default_rng(3000 + seed)
    n, d = SCALES[rng.integers(len(SCALES))]
    r = int(rng.choice([2, 4]))
    h = int(rng.integers(2, 5)) * d * n * r * 2
    w = int(rng.integers(2, 5)) * d * 2
    a = int(rng.integers(2, 4))
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", (h, w), scale=(n, d), a=a,
        align="center" if rng.integers(2) else "zero",
        edge_mode=EDGES[rng.integers(2)],  # clamp/drop
        dering=bool(rng.integers(2)),
        normalize=True,
    )
    img = rng.integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    mesh = Mesh.local(["cpu"] * (2 * r), (2, r))
    for backend in ("gather", "auto"):
        on = ShardedUpscaler(cfg, mesh, backend=backend)(img)
        off = ShardedUpscaler(cfg, mesh, backend=backend, overlap=False)(img)
        assert torch.equal(on, off), f"seed {seed} backend {backend}"
