"""The port against ``tests/test_review_regressions.py``'s ten findings, on
the same seeded numpy inputs as the JAX package.

Ported here: findings 1 (sharded ``hls`` index drift), 2 (bit precision
12 refused), 3 (dering on a downscale clamps to the band's central taps),
4 (``backend="ref"`` for ``hls`` runs the stream simulator), 5
(``shift_xla`` refuses the quantized intermediate), 6 (``--bench`` on the
``ref`` backend) and 9 (float output dtype equal on every float backend).

Held elsewhere already:
- finding 7, the stream simulator on inputs shorter than a + 1 rows:
  ``tests/test_torch_bitexact.py::test_hls_batched_and_short_inputs``;
- finding 8, ``c_oracle`` on a 5-D batch:
  ``tests/test_torch_bitexact.py::test_c_oracle_batched_and_leading_dims``;
- finding 10, ``backend="pallas"`` keeps a float input float:
  ``tests/test_torch_upscaler.py::test_float_and_uint16_on_kernel_backends_match_tpu_fallback``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as JaxConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as JaxUpscaler  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402
from lanczos_torch.parallel.sharded import ShardedUpscaler  # noqa: E402


def _rng():
    return np.random.default_rng(42)  # tests/conftest.py's rng fixture


def _cfg(profile, shape, **kw):
    return lanczos_torch.ResampleConfig.from_profile(profile, shape, **kw)


@pytest.mark.filterwarnings("ignore:HLS schedule indexes past:RuntimeWarning")
def test_sharded_hls_index_drift():
    """Finding 1: at 3/2 the quantized step predicate drifts past an a-row
    halo; the sharded ``hls`` path stays byte-equal to one device and to
    the JAX package."""
    cfg = _cfg("hls", (768, 16), scale=(3, 2), a=2)
    img = _rng().integers(0, 256, size=(1, 768, 16, 3), dtype=np.uint8)
    single = lanczos_torch.Upscaler(cfg, device="cpu")(img[0]).numpy()
    out = ShardedUpscaler(cfg, Mesh.local(["cpu"] * 4, (1, 4)))(img).numpy()[0]
    np.testing.assert_array_equal(out, single)
    jcfg = JaxConfig.from_profile("hls", (768, 16), scale=(3, 2), a=2)
    np.testing.assert_array_equal(single, np.asarray(JaxUpscaler(jcfg)(img[0])))


def test_bit_precision_overflow_rejected():
    """Finding 2: P >= 12 overflows the int32 horizontal MAC."""
    with pytest.raises(ValueError):
        _cfg("hls", (16, 16), scale=(2, 1), a=2, bit_precision=12)


def test_dering_downscale_central_taps():
    """Finding 3: gather-path dering on an antialiased downscale (band wider
    than 2a) clamps to the band's central taps, as the shift path and the
    JAX gather do."""
    cfg = _cfg("precise", (64, 64), scale=(1, 2), a=3, dering=True)
    img = _rng().integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    ref = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(img).numpy().astype(int)
    out = lanczos_torch.Upscaler(cfg, backend="shift_xla", device="cpu")(img).numpy()
    assert np.abs(ref - out.astype(int)).max() <= 1
    jcfg = JaxConfig.from_profile("precise", (64, 64), scale=(1, 2), a=3, dering=True)
    theirs = np.asarray(JaxUpscaler(jcfg, backend="xla")(img)).astype(int)
    assert np.abs(ref - theirs).max() <= 1


def test_hls_ref_backend_is_independent():
    """Finding 4: ``backend="ref"`` under ``hls`` runs the stream simulator,
    and the device path equals it."""
    from lanczos_torch.ref.hls_sim import hls_stream_upscale

    cfg = _cfg("hls", (24, 16), scale=(2, 1), a=2)
    img = _rng().integers(0, 256, size=(24, 16, 3), dtype=np.uint8)
    up = lanczos_torch.Upscaler(cfg, backend="ref", device="cpu")
    ref = np.asarray(up(img))
    sim = hls_stream_upscale(img, 48, 32, 2, cfg.bit_precision)
    np.testing.assert_array_equal(ref, sim)
    np.testing.assert_array_equal(lanczos_torch.Upscaler(cfg, device="cpu")(img).numpy(), sim)


def test_shift_backend_rejects_quantized_intermediate():
    """Finding 5: an explicit ``shift_xla`` refuses the quantized
    intermediate rather than dropping it."""
    cfg = _cfg("precise", (24, 20), scale=(2, 1), a=2, intermediate_quantize=True)
    with pytest.raises(NotImplementedError):
        lanczos_torch.Upscaler(cfg, backend="shift_xla", device="cpu")


def test_cli_bench_with_ref_backend(tmp_path):
    """Finding 6: ``--bench`` on the ``ref`` backend (numpy output)."""
    from lanczos_torch.cli import main
    from lanczos_torch.io import write_png

    img = _rng().integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    src = tmp_path / "in.png"
    write_png(src, img)
    rc = main([str(src), str(tmp_path / "o.png"), "--scale", "2", "--backend", "ref",
               "--no-psnr", "--bench", "2", "--device", "cpu"])
    assert rc == 0


def test_block_backend_output_dtype_matches_others():
    """Finding 9: float output carries the ops' dtype on every float
    backend (bf16 config, float32 input)."""
    cfg = _cfg("precise", (16, 16), scale=(2, 1), a=2, precision="bf16")
    x = _rng().random((16, 16, 3), dtype=np.float32) * 255
    dts = {b: lanczos_torch.Upscaler(cfg, backend=b, device="cpu")(x).dtype
           for b in ("xla", "shift_xla", "block")}
    assert len(set(dts.values())) == 1, dts
