"""The port's examples (``examples_torch/``) with ``--device cpu`` at small
sizes, against the JAX package on the same inputs, and the port's entry
points (``lanczos_torch.entry``) on CPU devices.

Limits: precise outputs ≤ 1 LSB on ≤ 1% of pixels against the JAX
package (its example 01, ``upscale_y4m``, ``VideoUpscaler``); the printed
shapes those of the JAX examples at the same sizes.  Each script runs in
this process as ``__main__`` (``runpy``), with its own ``sys.argv``.
"""

import pathlib
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.io import write_image, write_y4m  # noqa: E402
from lanczos_tpu.io.formats import decode_gif_frames, encode_gif  # noqa: E402

from lanczos_torch import entry as pentry  # noqa: E402
from lanczos_torch.io import read_image, read_y4m  # noqa: E402
from lanczos_torch.models.upscaler import Upscaler  # noqa: E402

from test_torch_jax_codecs import reference_codecs  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples_torch"


def _run(monkeypatch, capsys, script: str, *args) -> str:
    monkeypatch.setattr(sys, "argv", [script, *map(str, args)])
    runpy.run_path(str(EXAMPLES / script), run_name="__main__")
    return capsys.readouterr().out


def _within_1lsb(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_01_image_upscale(tmp_path, monkeypatch, capsys):
    img = np.random.default_rng(0).integers(0, 256, (20, 24, 3), dtype=np.uint8)
    write_image(tmp_path / "in.jpg", img)
    out = _run(monkeypatch, capsys, "01_image_upscale.py", tmp_path / "in.jpg",
               tmp_path / "out.png", "--device", "cpu")
    src = read_image(tmp_path / "in.jpg")
    want = np.asarray(lanczos_tpu.upscale(src, scale=(2, 1), a=3))
    _within_1lsb(read_image(tmp_path / "out.png"), want)
    assert "(20, 24, 3) -> (40, 48, 3)" in out


@pytest.mark.parametrize("scale", ["2", "3/2"])
def test_02_video_y4m(tmp_path, monkeypatch, capsys, scale):
    rng = np.random.default_rng(1)
    frames = [tuple(rng.integers(0, 256, s, dtype=np.uint8) for s in ((16, 24), (8, 12), (8, 12)))
              for _ in range(3)]
    write_y4m(str(tmp_path / "in.y4m"), frames, fps=(24, 1), colorspace="420jpeg")
    out = _run(monkeypatch, capsys, "02_video_y4m.py", tmp_path / "in.y4m",
               tmp_path / "out.y4m", scale, "--device", "cpu")
    n, _, d = scale.partition("/")
    lanczos_tpu.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "want.y4m"),
                            scale=(int(n), int(d or 1)), a=3, batch=8)
    ghdr, got = read_y4m((tmp_path / "out.y4m").read_bytes())
    whdr, want = read_y4m((tmp_path / "want.y4m").read_bytes())
    assert (ghdr.width, ghdr.height, ghdr.colorspace) == (whdr.width, whdr.height,
                                                          whdr.colorspace)
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            _within_1lsb(gp, wp)
    assert f"{whdr.width}x{whdr.height} C420jpeg" in out


@pytest.mark.parametrize("n,mesh", [(2, "1x2"), (8, "2x4")])
def test_03_sharded_mesh(monkeypatch, capsys, n, mesh):
    out = _run(monkeypatch, capsys, "03_sharded_mesh.py", "--device", "cpu", "--n", n,
               "--size", "32x40")
    batch = 2 * int(mesh.split("x")[0])
    assert f"({batch}, 32, 40, 3) -> ({batch}, 64, 80, 3) across {n} positions ({mesh} mesh)" in out


def test_04_streaming_tall_frame(monkeypatch, capsys):
    out = _run(monkeypatch, capsys, "04_streaming_tall_frame.py", "--device", "cpu", "--size",
               "128x48")
    assert "-> (256, 96, 3)" in out


@pytest.mark.usefixtures("reference_codecs")
def test_05_gif_animation(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(2)
    clip = rng.integers(0, 4, (3, 12, 10, 3), dtype=np.uint8) * 80
    (tmp_path / "in.gif").write_bytes(encode_gif(clip, delays_cs=[4, 5, 6]))
    out = _run(monkeypatch, capsys, "05_gif_animation.py", tmp_path / "in.gif",
               tmp_path / "out", "2/1", "--device", "cpu")
    frames, delays = decode_gif_frames((tmp_path / "in.gif").read_bytes())
    cfg = lanczos_tpu.ResampleConfig(in_shape=(12, 10), out_shape=(24, 20), a=3, channels=4)
    want = np.asarray(lanczos_tpu.VideoUpscaler(cfg, batch=3)(np.ascontiguousarray(frames)))
    for k, delay in enumerate(delays):
        got = read_image(tmp_path / "out" / f"frame_{k:04d}_{delay}ms.png")
        _within_1lsb(got[..., :3], want[k, ..., :3])
        # alpha is a constant 255 plane (JAX: 255 everywhere); the port's
        # fp32 fused path gives 254 at about half the pixels of the last
        # output row and column (ROADMAP queue 3): 10% of this 24x20 plane
        alpha = got[..., 3]
        assert (alpha[:-1, :-1] == 255).all() and alpha.min() >= 254
    gif, _ = decode_gif_frames((tmp_path / "out" / "upscaled.gif").read_bytes())
    assert gif.shape == (3, 24, 20, 4)
    assert "wrote 3 frames at 20x24" in out


@pytest.mark.parametrize("n,mesh", [(2, "1x2"), (8, "2x4")])
def test_06_sharded_video_stream(monkeypatch, capsys, n, mesh):
    out = _run(monkeypatch, capsys, "06_sharded_video_stream.py", "--device", "cpu", "--n", n,
               "--size", "32x48")
    data_n = int(mesh.split("x")[0])
    assert f"streamed {3 * data_n + 1} frames through the {mesh} mesh" in out
    assert f"tall frame: {n * 32} rows in, {2 * n * 32} rows out" in out


def test_examples_need_a_card_without_device_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script, args in (("03_sharded_mesh.py", ["--n", "2"]),
                         ("04_streaming_tall_frame.py", ["--size", "64x32"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run(monkeypatch, capsys, script, *args)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_on_cpu_devices(n):
    pentry.dryrun_multichip(n, ["cpu"] * n)


def test_entry_and_its_refusals(monkeypatch):
    model, (img,) = pentry.entry(device="cpu")
    assert isinstance(model, Upscaler) and model.backend == "cuda"
    assert model.cfg.in_shape == (2160, 3840) and model.cfg.out_shape == (4320, 7680)
    assert img.shape == (2160, 3840, 3) and img.dtype == torch.uint8 and not img.any()
    with pytest.raises(ValueError, match="3 devices for a mesh of 2"):
        pentry.dryrun_multichip(2, ["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pentry.entry()

