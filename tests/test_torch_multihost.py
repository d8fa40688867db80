"""``lanczos_torch.parallel.multihost`` on the CPU: the analytic models
against the JAX package's formulas given the same parameters, the meshes
it builds and refuses, and one run of two processes over gloo whose rows
axis spans both, so that the ring carries real halos between them.

Limits: the models' numbers equal the reference's to float rounding
(``pytest.approx``); every shard of the two-process run identical bytes to
the single-process result of the same path.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.parallel import multihost as tpu_mh  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.parallel import multihost as mh  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402

FRAME = dict(in_shape=(2160, 3840), out_shape=(4320, 7680))


def _cfgs(ins=FRAME["in_shape"], outs=FRAME["out_shape"], a=3):
    return (lanczos_torch.ResampleConfig.from_profile("precise", ins, out_shape=outs, a=a),
            lanczos_tpu.ResampleConfig.from_profile("precise", ins, out_shape=outs, a=a))


@pytest.mark.parametrize("ins,outs,a", [
    ((2160, 3840), (4320, 7680), 3),
    ((1080, 1920), (540, 960), 3),  # downscale: an a·D/N-row halo
    ((1440, 2560), (2160, 3840), 2),
])
@pytest.mark.parametrize("kw", [
    dict(ici_bw=9.0e10, latency_s=1e-6),
    dict(ici_bw=1e8, latency_s=1e-4),
    dict(ici_bw=4.5e11, latency_s=2e-6, halo_bytes=12345),
    dict(ici_bw=4.5e11, latency_s=2e-6, boundary_fraction=0.3, channels=1, dtype_bytes=4),
])
@pytest.mark.parametrize("rows_n,frame_s", [(8, 0.58e-3), (4, 0.1394e-3), (2, 1e-6)])
def test_ici_halo_model_equals_the_reference(ins, outs, a, kw, rows_n, frame_s):
    cfg, tcfg = _cfgs(ins, outs, a)
    got = mh.ici_halo_model(cfg, rows_n, frame_s, **kw)
    assert got == pytest.approx(tpu_mh.ici_halo_model(tcfg, rows_n, frame_s, **kw))


@pytest.mark.parametrize("kw", [
    dict(dcn_bw=1.25e10, latency_s=1e-5),
    dict(dcn_bw=5e10, latency_s=1e-5, hosts=4, frames_per_step=4),
    dict(dcn_bw=5e10, latency_s=0.0, remote_fraction=0.0),
    dict(dcn_bw=1e9, latency_s=1e-3, in_bytes=2, out_bytes=2, channels=1),
])
@pytest.mark.parametrize("step_s", [4 * 0.58e-3 / 8, 1e-3, 0.5])
def test_dcn_model_equals_the_reference(kw, step_s):
    cfg, tcfg = _cfgs()
    assert mh.dcn_model(cfg, step_s, **kw) == pytest.approx(
        tpu_mh.dcn_model(tcfg, step_s, **kw))


def test_scaling_efficiency_and_link_defaults():
    assert mh.scaling_efficiency(800.0, 100.0, 8) == 1.0
    assert mh.scaling_efficiency(680.0, 100.0, 8) == pytest.approx(0.85)
    # the defaults are NVLink 4 and InfiniBand NDR figures, not the TPU's
    assert mh.NVLINK4_BYTES_S == 4.5e11 and mh.NDR_BYTES_S == 5.0e10
    cfg, _ = _cfgs()
    m = mh.ici_halo_model(cfg, 4, 0.1394e-3)
    assert m["halo_bytes"] == 3 * 3840 * 3  # 34.6 KB a direction a shard
    assert m["t_halo_s"] == pytest.approx(1e-6 + 34560 / 4.5e11)
    assert m["exposed_s"] == 0.0 and m["efficiency"] == 1.0
    d = mh.dcn_model(cfg, 1e-3)
    assert d["t_dcn_s"] == pytest.approx(1e-5 + 0.5 * (24883200 + 99532800) / 5e10)


def test_dcn_aware_mesh_shapes_and_refusals():
    cpus = ["cpu"] * 8
    mesh = mh.dcn_aware_mesh(rows_per_host=4, devices=cpus)
    assert mesh.shape == {"data": 2, "rows": 4} and mesh.is_local
    assert mh.dcn_aware_mesh(rows_per_host=2, devices=cpus).shape == {"data": 4, "rows": 2}
    assert mh.dcn_aware_mesh(devices=cpus).shape == {"data": 1, "rows": 8}
    with pytest.raises(ValueError, match="not divisible"):
        mh.dcn_aware_mesh(rows_per_host=3, devices=cpus)
    with pytest.raises(ValueError, match="not divisible"):
        mh.dcn_aware_mesh(rows_per_host=16, devices=cpus)
    # a sharded frame on it equals the single device's
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (32, 16), scale=(2, 1), a=2)
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32, 16, 3), np.uint8))
    got = lanczos_torch.ShardedUpscaler(cfg, mesh, backend="gather")(img)
    assert torch.equal(got, lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(img))


def test_measure_ici_bw_refuses_one_distinct_device():
    with pytest.raises(ValueError, match="distinct devices"):
        mh.measure_ici_bw(Mesh.local(["cpu"] * 8, (2, 4)), nbytes=1 << 10, iters=3)
    with pytest.raises(ValueError, match="distinct devices"):
        mh.measure_ici_bw(Mesh.local(["cpu"] * 4, (4, 1)), nbytes=1 << 10, iters=3)
    with pytest.raises(RuntimeError, match="initialize"):
        Mesh.distributed((1, 2))


_WORKER = r'''
import sys
import numpy as np, torch
pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from lanczos_torch.parallel import multihost
multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid, backend="gloo",
                     timeout_s=50)
multihost.initialize(f"127.0.0.1:{port}", 2, pid)  # a second call is a no-op
import lanczos_torch
from lanczos_torch.parallel.mesh import Mesh
ring = Mesh.distributed((1, 4), ["cpu", "cpu"])  # rows 0-1 here, 2-3 on the other rank
assert ring.local_positions() == [(0, 2 * pid), (0, 2 * pid + 1)] and not ring.is_local
img = np.random.default_rng(0).integers(0, 256, (2, 32, 24, 3), np.uint8)
lines = []
for profile, kw, backend in (
        ("precise", dict(a=2), "gather"),  # the shift path
        ("precise", dict(a=3, edge_mode="drop"), "gather"),  # the gather path, overlapped
        ("precise", dict(a=3, dering=True), "mxu"),  # the fused kernel's plain version
        ("hls", dict(a=2), "auto"),
        ("c_oracle", dict(a=3), "auto")):
    cfg = lanczos_torch.ResampleConfig.from_profile(profile, (32, 24), scale=(2, 1), **kw)
    single = lanczos_torch.Upscaler(cfg, backend="xla" if backend == "gather" else "auto",
                                    device="cpu")(torch.from_numpy(img))
    for shape in ((1, 4), (2, 2)):
        mesh = Mesh.distributed(shape, ["cpu", "cpu"])
        sh = lanczos_torch.ShardedUpscaler(cfg, mesh, backend=backend)
        bl, ol = img.shape[0] // shape[0], sh.out_h_local
        parts = sh.shards(img)
        ok = len(parts) == 2 and all(
            torch.equal(y, single[d * bl : (d + 1) * bl, r * ol : (r + 1) * ol])
            for (d, r), y in parts.items())
        ok = ok and torch.equal(sh(img), single)  # every rank gathers the whole frame
        lines.append(f"{profile} {backend} {shape} {'PASS' if ok else 'FAIL'}")
dcn = multihost.dcn_aware_mesh(rows_per_host=2, devices=["cpu", "cpu"])
ok = dcn.shape == {"data": 2, "rows": 2} and dcn.local_positions() == [(pid, 0), (pid, 1)]
try:  # a rows ring across the ranks is what dcn_aware_mesh refuses
    multihost.dcn_aware_mesh(rows_per_host=2, devices=["cpu"])
    ok = False
except ValueError as e:
    ok = ok and "must divide the local device count" in str(e)
lines.append(f"dcn_aware_mesh {'PASS' if ok else 'FAIL'}")
bw = multihost.measure_ici_bw(ring, nbytes=1 << 16, iters=3)
lines.append(f"bw {bw:.0f}")
open(f"{outdir}/result_{pid}", "w").write("\n".join(lines))
'''


def test_two_process_gloo_ring_equals_one_process(tmp_path):
    """Two processes under torch.distributed (a local TCP store, gloo): the
    rows axis spans both ranks, so every halo crossing between rows 1 and
    2 (and the ring's wrap) goes through batch_isend_irecv.  Every shard
    equals the single-process result; every path runs."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(pid), str(port), str(tmp_path)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("the two-process gloo run took over 60 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for pid in range(2):
        lines = (tmp_path / f"result_{pid}").read_text().splitlines()
        assert len(lines) == 12 and all(line.endswith("PASS") for line in lines[:-1]), lines
        assert float(lines[-1].split()[1]) > 0


def test_multicard_tool_on_two_cpu_ranks(tmp_path, monkeypatch, capsys):
    """``python -m lanczos_torch.tools.multicard --cpu``: the four-card
    check's launcher, here on two gloo ranks at a small shape; every path's
    shard equals the single-device rows on its rank."""
    from lanczos_torch.tools import multicard

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", repo)
    assert multicard.main(["--ranks", "2", "--cpu", "--shape", "32x48",
                           "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert '"ok": true' in out and out.count("identical to the single-device rows") == len(
        multicard.CASES)
