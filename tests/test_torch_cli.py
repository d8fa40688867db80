"""The port's CLI (``python -m lanczos_torch``, ``--device cpu``) against
the JAX CLI (``lanczos_tpu.cli.main``) on the same files: the cases of
``tests/test_cli.py``, the goldens, the error checks, ``--bench`` and the
refusal to run without a card.

Limits: ``hls`` and ``c_oracle`` identical output bytes and identical
printed RMS lines; ``precise`` fp32 ≤ 1 LSB on ≤ 1% of pixels against the
JAX output, bf16 ≤ 3 LSB on ≤ 50% against the JAX fp32 output; the
goldens under ``tests/data/`` byte for byte; ``--info`` lines and
``p.error`` messages identical.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.cli import main as tmain  # noqa: E402
from lanczos_tpu.io import write_image as twrite  # noqa: E402
from lanczos_tpu.io import write_y4m  # noqa: E402

from lanczos_torch.cli import main as pmain  # noqa: E402
from lanczos_torch.io import read_image  # noqa: E402

from test_torch_jax_codecs import reference_codecs  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50), "exact": (0, 0.0)}


def _within(got: np.ndarray, want: np.ndarray, limit: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    lim, frac = LIMITS[limit]
    assert d.max() <= lim and (d > 0).mean() <= frac, (d.max(), (d > 0).mean())


def _rms_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("RMS error")]


def _both(tmp_path, capsys, img, args, name="in.png", out=True):
    """Run each CLI on its own copy of ``img`` (written by the JAX package):
    (port output, JAX output, port stdout, JAX stdout)."""
    res = []
    for tag, main in (("p", pmain), ("t", tmain)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        src = d / name
        twrite(src, img)
        argv = [str(src)] + ([str(d / "out.png")] if out else []) + list(args)
        if tag == "p":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        res.append(capsys.readouterr().out)
    outs = [read_image(tmp_path / t / "out.png") if out else None for t in "pt"]
    return outs[0], outs[1], res[0], res[1]


@pytest.mark.parametrize("profile,a,scale,backend", [
    ("c_oracle", 2, "2/1", "xla"), ("c_oracle", 3, "2/1", "auto"), ("c_oracle", 2, "3/2", "auto"),
    ("c_oracle", 2, "2/1", "c_exact"), ("hls", 2, "2/1", "auto"), ("hls", 3, "2/1", "auto"),
    ("hls", 2, "3/2", "xla"),
])
def test_bit_exact_profiles_equal_the_jax_cli(tmp_path, capsys, profile, a, scale, backend):
    img = np.random.default_rng(1).integers(0, 256, (24, 20, 3), dtype=np.uint8)
    got, want, pout, tout = _both(tmp_path, capsys, img, [
        "--scale", scale, "--a", str(a), "--profile", profile, "--backend", backend,
        "--expected"])
    _within(got, want, "exact")
    assert _rms_lines(pout) == _rms_lines(tout) and len(_rms_lines(pout)) == 1
    assert ("PSNR: inf" in pout) == (profile == "c_oracle")
    ex = [sorted((tmp_path / t).glob("*expected.png")) for t in "pt"]
    assert len(ex[0]) == 1 and ex[0][0].name == ex[1][0].name
    assert ex[0][0].read_bytes() == ex[1][0].read_bytes()


def test_default_output_name(tmp_path, capsys):
    img = np.random.default_rng(2).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    _, _, pout, _ = _both(tmp_path, capsys, img, ["--scale", "3/1", "--a", "2", "--no-psnr"],
                          out=False)
    outs = [sorted((tmp_path / t).glob("*observed.png")) for t in "pt"]
    assert len(outs[0]) == 1 and outs[0][0].name == outs[1][0].name
    assert "16x16->48x48_3|1_2-" in outs[0][0].name  # full_TB.h:170 pattern
    assert f"wrote {outs[0][0]}" in pout and "backend=cuda" in pout
    _within(read_image(outs[0][0]), read_image(outs[1][0]), "fp32")


@pytest.mark.parametrize("c", [1, 2, 4])
def test_alpha_dropped_and_gray_replicated(tmp_path, capsys, c):
    img = np.random.default_rng(c).integers(0, 256, (16, 16, c), dtype=np.uint8)
    got, want, _, _ = _both(tmp_path, capsys, img[..., 0] if c == 1 else img,
                            ["--scale", "2", "--no-psnr"])
    assert got.shape == (32, 32, 3)
    _within(got, want, "fp32")


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("ext", ["png", "jpg", "bmp", "tga", "ppm", "hdr", "gif"])
def test_info_lines_equal(tmp_path, capsys, ext):
    img = np.random.default_rng(3).integers(0, 256, (12, 34, 3), dtype=np.uint8)
    p = tmp_path / f"x.{ext}"
    twrite(p, img)
    assert pmain([str(p), "--info"]) == 0
    pout = capsys.readouterr().out
    assert tmain([str(p), "--info"]) == 0
    assert pout == capsys.readouterr().out and "34x12" in pout


@pytest.mark.parametrize("args,label", [
    (["--scale", "1/2", "--a", "2"], "RMS error vs fp64 ref backend"),
    (["--scale", "2/1", "--a", "2", "--align", "center"], "fp64 ref backend"),
    (["--scale", "2/1", "--a", "2"], "RMS error vs fp64 oracle"),
    (["--out-size", "47x41", "--a", "3"], "RMS error vs fp64 oracle"),
])
def test_precise_and_the_oracle_fallback(tmp_path, capsys, args, label):
    img = np.random.default_rng(4).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    got, want, pout, tout = _both(tmp_path, capsys, img, args)
    _within(got, want, "fp32")
    assert label in pout and label in tout


@pytest.mark.parametrize("backend", ["pallas", "shift_xla", "block", "xla", "ref"])
def test_backends_against_the_jax_cli(tmp_path, capsys, backend):
    img = np.random.default_rng(5).integers(0, 256, (20, 24, 3), dtype=np.uint8)
    got, want, pout, _ = _both(tmp_path, capsys, img,
                               ["--scale", "2/1", "--backend", backend, "--no-psnr"])
    _within(got, want, "fp32")
    assert f"backend={backend}" in pout


def test_precision_bf16(tmp_path, capsys):
    img = np.random.default_rng(6).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    src = tmp_path / "in.png"
    twrite(src, img)
    assert pmain([str(src), str(tmp_path / "p.png"), "--scale", "2/1", "--a", "2",
                  "--precision", "bf16", "--no-psnr", "--device", "cpu"]) == 0
    assert tmain([str(src), str(tmp_path / "t.png"), "--scale", "2/1", "--a", "2",
                  "--no-psnr"]) == 0
    _within(read_image(tmp_path / "p.png"), read_image(tmp_path / "t.png"), "bf16")


@pytest.mark.parametrize("args", [
    ["--profile", "hls", "--precision", "bf16"],
    ["--backend", "c_exact"],
    ["--bench", "2"],  # on a .y4m input
    ["--profile", "c_oracle", "--precision", "fp32"],  # on a .y4m input
])
def test_refusals_equal(tmp_path, capsys, args):
    name = "in.y4m" if args[0] == "--bench" or "fp32" in args else "in.png"
    src = tmp_path / name
    if name.endswith(".y4m"):
        write_y4m(str(src), [(np.zeros((8, 8), np.uint8),)], colorspace="mono")
    else:
        twrite(src, np.zeros((8, 8, 3), np.uint8))
    errs = []
    for main in (pmain, tmain):
        with pytest.raises(SystemExit) as e:
            main([str(src)] + args)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1].replace("lanczos_torch", "PROG")
                    .replace("lanczos_tpu", "PROG"))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("profile,scale,a,name", [
    ("c_oracle", "2/1", 2, "golden_c_oracle_2x_a2.png"),
    ("c_oracle", "2/1", 3, "golden_c_oracle_2x_a3.png"),
    ("c_oracle", "3/2", 2, "golden_c_oracle_3over2_a2.png"),
    ("hls", "2/1", 2, "golden_hls_2x_a2.png"),
    ("hls", "2/1", 3, "golden_hls_2x_a3.png"),
    ("hls", "3/2", 2, "golden_hls_3over2_a2.png"),
])
def test_goldens_byte_for_byte(tmp_path, capsys, profile, scale, a, name):
    """The goldens of ``tests/test_golden.py`` that the CLI can reach (it
    has no bit-precision flag, as the JAX CLI has none)."""
    out = tmp_path / "out.png"
    assert pmain([str(DATA / "input_48x40.png"), str(out), "--profile", profile, "--scale",
                  scale, "--a", str(a), "--device", "cpu"]) == 0
    assert out.read_bytes() == (DATA / name).read_bytes()
    assert ("PSNR: inf" in capsys.readouterr().out) == (profile == "c_oracle")


@pytest.mark.parametrize("profile", ["hls", "precise"])
def test_y4m_branch_equals_the_jax_cli(tmp_path, capsys, profile):
    rng = np.random.default_rng(7)
    frames = [tuple(rng.integers(0, 256, s, dtype=np.uint8) for s in ((16, 24), (8, 12), (8, 12)))
              for _ in range(3)]
    src = tmp_path / "in.y4m"
    write_y4m(str(src), frames, fps=(25, 1), colorspace="420jpeg")
    assert pmain([str(src), str(tmp_path / "p.y4m"), "--profile", profile, "--a", "2",
                  "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert tmain([str(src), str(tmp_path / "t.y4m"), "--profile", profile, "--a", "2"]) == 0
    got, want = (tmp_path / "p.y4m").read_bytes(), (tmp_path / "t.y4m").read_bytes()
    if profile == "hls":
        assert got == want
    else:
        head = got.index(b"\n") + 1
        assert got[:head] == want[:head] and len(got) == len(want)
        g = np.frombuffer(got, np.uint8).astype(int)
        w = np.frombuffer(want, np.uint8).astype(int)
        assert np.abs(g - w).max() <= 1 and (g != w).mean() <= 0.01
    default = tmp_path / "in_upscaled.y4m"
    assert pmain([str(src), "--profile", "hls", "--device", "cpu"]) == 0
    assert default.exists()


def test_bench_line_on_the_cpu(tmp_path, capsys):
    src = tmp_path / "in.png"
    twrite(src, np.random.default_rng(8).integers(0, 256, (16, 24, 3), dtype=np.uint8))
    assert pmain([str(src), str(tmp_path / "o.png"), "--bench", "2", "--no-psnr",
                  "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("bench:")]
    assert len(line) == 1 and "ms/frame" in line[0] and "Mpix/s" in line[0]


def test_no_card_and_no_device_flag_fails(tmp_path):
    """``python -m lanczos_torch in.png`` with no CUDA device exits non-zero
    with the message of the port's device check; it never runs on the CPU
    by itself."""
    src = tmp_path / "in.png"
    twrite(src, np.zeros((8, 8, 3), np.uint8))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "lanczos_torch", str(src), "--no-psnr"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not list(tmp_path.glob("*observed.png"))
