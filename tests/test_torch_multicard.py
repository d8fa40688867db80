"""``python -m lanczos_torch.tools.multicard --local`` on the CPU, and
``chip_smoke.py``'s spread of mesh positions over the cards.

The one-process form runs every case of ``LOCAL_CASES`` on every (data,
rows) split of N CPU positions (the kernels' plain versions), each shard
identical bytes to the single-device result of its path; a difference, a
failure and a request for more CUDA cards than exist each exit 1, the last
before anything runs.  The gathered frame of the (2, 2) mesh is held to the
JAX package's ``ShardedUpscaler`` on a 2×2 ``jax`` mesh within its fp32
contract.

Limits: identical bytes between the port's paths; the JAX comparison ≤ 1
LSB on ≤ 1% of pixels (the reference's fp32 contract).
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from lanczos_tpu import ResampleConfig as TpuConfig  # noqa: E402
from lanczos_tpu.parallel.sharded import ShardedUpscaler as TpuSharded  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402
from lanczos_torch.tools import multicard  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = "64x48"


def _lines(out: str) -> list:
    return [json.loads(v) for v in out.splitlines() if v.startswith("{")]


@pytest.mark.parametrize("n", [2, 4])
def test_local_form_on_cpu_positions(n, capsys):
    assert multicard.main(["--local", "--cpu", "--ranks", str(n), "--shape", SHAPE]) == 0
    out = capsys.readouterr().out
    *meshes, last = _lines(out)
    assert [m["mesh"] for m in meshes] == [list(s) for s in multicard.splits(n)]
    assert last["ok"] is True and last["form"] == "local" and last["cards"] == n
    assert "peer_access" not in last and "copy_gb_s" not in last  # no cards to link
    assert sorted(last["one_frame_ms_by_rows"]) == sorted(str(r) for _, r in multicard.splits(n))
    names = [c[0] for c in multicard.LOCAL_CASES]
    for m in meshes:
        assert "error" not in m and m["video_ok"] and list(m["cases"]) == names
        assert all(c["ok"] for c in m["cases"].values())
        assert m["devices"] == ["cpu"] * n
        D = m["mesh"][0]
        assert [c["batch"] for c in m["cases"].values()] == [
            c[5].get("batch", D) for c in multicard.LOCAL_CASES]
        assert m["cases"]["fused fp32"]["fused"] and not m["cases"]["uint16 (float path)"]["fused"]
        assert m["cases"]["shift"]["shift"] and m["ring_bytes_s"] is None  # one CPU: no ring
        assert m["ring_256mib_bytes_s"] is None
        lo, hi = m["video_frames_s_band"]
        assert 0 < lo <= m["video_frames_s"] <= hi
    assert out.count("every shard identical to the single-device rows on its card") == (
        len(meshes) * len(names))
    assert out.count("every frame identical to one card") == len(meshes)


def test_local_form_exits_1_on_a_difference(monkeypatch, capsys):
    real = lanczos_torch.ShardedUpscaler.shards

    def off_by_one(self, img):
        parts = real(self, img)
        last = max(parts)
        parts[last] = parts[last].clone()
        parts[last].view(-1)[0] += 1
        return parts

    monkeypatch.setattr(lanczos_torch.ShardedUpscaler, "shards", off_by_one)
    monkeypatch.setattr(multicard, "LOCAL_CASES", multicard.LOCAL_CASES[:1])
    assert multicard.main(["--local", "--cpu", "--ranks", "2", "--shape", SHAPE]) == 1
    out = capsys.readouterr().out
    assert _lines(out)[-1]["ok"] is False
    assert "fused fp32: DIFFERS from the single-device rows" in out


def test_local_form_exits_1_on_a_failure(monkeypatch, capsys):
    def fails(*a, **kw):
        raise RuntimeError("no halo")

    monkeypatch.setattr(multicard, "LOCAL_CASES", multicard.LOCAL_CASES[:1])
    monkeypatch.setattr("lanczos_torch.parallel.mesh.halo_permutes", fails)
    assert multicard.main(["--local", "--cpu", "--ranks", "2", "--shape", SHAPE]) == 1
    out = capsys.readouterr().out
    assert "(1, 2) FAILED: RuntimeError: no halo" in out and _lines(out)[-1]["ok"] is False


@pytest.mark.parametrize("form", [["--local"], []])
def test_more_cards_than_exist_exit_1_before_running(form, monkeypatch, capsys):
    def never(*a, **kw):
        raise AssertionError("ran on fewer cards than asked")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(multicard, "local_main", never)
    monkeypatch.setattr(multicard.subprocess, "Popen", never)
    monkeypatch.setattr(multicard, "peer_access", never)
    assert multicard.main(form + ["--ranks", "4"]) == 1
    assert "need 4 CUDA devices, 2 found" in capsys.readouterr().out


@pytest.mark.parametrize("n,want", [
    (1, [(1, 1)]), (2, [(1, 2), (2, 1)]), (4, [(1, 4), (2, 2), (4, 1)]),
    (8, [(1, 8), (2, 4), (4, 2), (8, 1)]),
])
def test_splits(n, want):
    assert multicard.splits(n) == want


def test_chip_smoke_spreads_positions_over_the_cards():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.spread(8, 1) == ["cuda:0"] * 8
    assert chip_smoke.spread(8, 4) == [f"cuda:{i}" for i in range(4)] * 2
    assert chip_smoke.spread(4, 4) == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert chip_smoke.spread(4, 8) == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]


def test_local_mesh_frame_within_the_reference_contract():
    """The (2, 2) CPU mesh of the local form against the JAX package's
    ``ShardedUpscaler`` on a 2x2 mesh of the virtual CPU devices."""
    h, w = (int(v) for v in SHAPE.split("x"))
    img = np.random.default_rng(0).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (h, w), scale=(2, 1), a=3)
    got = lanczos_torch.ShardedUpscaler(cfg, Mesh.local(["cpu"] * 4, (2, 2)))(img).numpy()
    tcfg = TpuConfig.from_profile("precise", (h, w), scale=(2, 1), a=3)
    want = np.asarray(TpuSharded(tcfg, jax.make_mesh((2, 2), ("data", "rows")))(img))
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and d.max() <= 1 and (d > 0).mean() <= 0.01
