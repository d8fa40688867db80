"""The harness on the CPU: it finds every piece by name, a cell added as new
files is found without an edit, every driver runs to its outputs through
the program's plain versions, and no module it loads is JAX's.

    python -m pytest benchmark/tests
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import bounds, devtrace, harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
# the configurations' scales at a size the plain versions run in milliseconds
TINY = {"fsr1-performance-8k": ((24, 32), (48, 64)), "fsr1-quality-4k": ((32, 48), (48, 72))}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny(cell: harness.Cell):
    return TINY[cell.config["name"]]


def test_every_piece_is_found_by_name():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and c["reduced"] == []
        assert c["file"].startswith("benchmark/configs/")
    for name in CELLS:
        cell = harness.find_cell(name)
        harness.load(ROOT, "drivers", cell.traffic["driver"]).Driver
        harness.program_config(cell.config, cell.config["precision"])
    for m in SPEC["per_layer"]:
        assert callable(harness.load(ROOT, "metrics", m["name"]).read)
    for name in CELLS:
        listed = harness.listed(SPEC, name, "end_to_end")
        assert "setup_s" in {m["name"] for m in listed} and len(listed) >= 2
        assert harness.listed(SPEC, name, "per_layer")
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell")


def test_benchmark_json_keeps_the_contract_limits():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["paths"] == ["benchmark"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_a_cell_added_as_new_files_is_found_without_an_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bm = tmp_path / "benchmark"
    conf = json.loads((bm / "configs" / "fsr1-quality-4k.json").read_text())
    conf["name"] = "fsr1-balanced-4k"
    (bm / "configs" / "fsr1-balanced-4k.json").write_text(json.dumps(conf))
    (bm / "traffic" / "oncard-batch2-planar.json").write_text(json.dumps(
        {"driver": "oncard", "entry": "planar", "batch": 2, "distinct": 2, "sample": 2}))
    (bm / "metrics" / "frames.traced.py").write_text(textwrap.dedent('''
        def read(m):
            return m.frames or None
        '''))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "fsr1-balanced-4k", "source": "x", "reduced": [],
                            "file": "benchmark/configs/fsr1-balanced-4k.json", "why": "x"})
    spec["workloads"].append({"name": "balanced-batch2", "config": "fsr1-balanced-4k",
                              "traffic": "oncard-batch2-planar", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("balanced-batch2")
    spec["per_layer"].append({"name": "frames.traced", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "harness",
                              "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["balanced-batch2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell("balanced-batch2", root=tmp_path)
    assert cell.root == tmp_path and cell.traffic["batch"] == 2
    assert "frames.traced" in {m["name"] for m in harness.listed(spec, cell.name, "per_layer")}
    assert harness.load(tmp_path, "metrics", "frames.traced").read(
        harness.MetricInput(None, 7, {}, cell, None)) == 7
    r = harness.execute(cell, 11, 0.05, False, device="cpu", shape=TINY["fsr1-quality-4k"])
    assert r["correct"], r
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


@pytest.mark.parametrize("name", CELLS)
def test_each_driver_runs_to_its_outputs_on_the_cpu(name):
    cell = harness.find_cell(name)
    r = harness.execute(cell, 2**31 + 5, 0.1, False, device="cpu", shape=tiny(cell))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "check" and r["check"]["gap_lsb"]["value"] < 1e-3


# the values each driver's window returns on the card
DRIVER_VALUES = {"oncard": {"mpix_s": 1.0, "call_ms_p95": 2.0, "window_s": 3.0},
                 "video": {"video_fps": 4.0, "video_frame_ms_p95": 5.0, "window_s": 6.0}}


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_its_listed_metrics(name):
    cell = harness.find_cell(name)
    values = DRIVER_VALUES[cell.traffic["driver"]]
    e2e = harness.end_to_end(cell, values, 7.0)
    assert set(e2e) == {m["name"] for m in harness.listed(SPEC, name, "end_to_end")}
    assert e2e["setup_s"]["value"] == 7.0
    for metric, v in e2e.items():
        assert v["value"] in values.values() or metric == "setup_s"
    if cell.chips == 4:
        assert e2e["video_fps.4card"]["value"] == values["video_fps"]
    t = devtrace.TraceSummary(1.0, list(range(cell.chips)), [
        devtrace.DeviceOp(d, k, n, 0.1, 0.2) for d in range(cell.chips) for k, n in (
            ("kernel", "fused_resample_kernel"), ("kernel", "elementwise_kernel"),
            ("memcpy_htod", "Memcpy HtoD"), ("memcpy_dtoh", "Memcpy DtoH"),
            ("memcpy_ptop", "Memcpy PtoP"))], [])
    bound = bounds.resample_bound(cell.config["in_shape"], cell.config["out_shape"], 3, 3)
    pl = harness.per_layer(cell, harness.MetricInput(t, 100, bound, cell, None))
    assert set(pl) == {m["name"] for m in harness.listed(SPEC, name, "per_layer")}


def test_the_same_seed_gives_the_same_inputs():
    import torch

    cell = harness.find_cell(CELLS[0])
    drivers = []
    for seed in (9, 9, 10):
        cfg = harness.program_config(cell.config, "fp32", tiny(cell))
        ctx = harness.Context(cell, cfg, seed, [torch.device("cpu")], False)
        d = harness.load(ROOT, "drivers", cell.traffic["driver"]).Driver(ctx)
        d.setup()
        drivers.append(d.input_planes(1))
    assert torch.equal(drivers[0], drivers[1]) and not torch.equal(drivers[0], drivers[2])


def test_sampler_keeps_k_and_the_last_drawn_from_the_seed():
    picks = []
    for seed in (3, 3, 4):
        s = harness.Sampler(4, seed)
        for i in range(1000):
            s.offer(i % 5, i)
        picks.append([i for i, _, _ in s.items()])
    assert picks[0] == picks[1] != picks[2]
    assert len(picks[0]) == 5 and picks[0][-1] == 999


def test_run_exits_2_and_prints_nothing_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def test_no_module_the_harness_loads_is_jax():
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from benchmark import bounds, devtrace, harness
        for name in {CELLS!r}:
            cell = harness.find_cell(name)
            shape = {TINY!r}[cell.config["name"]]
            assert harness.execute(cell, 1, 0.05, True, device="cpu", shape=shape)["correct"]
            for m in cell.spec["per_layer"]:
                harness.load(cell.root, "metrics", m["name"])
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "lanczos_torch" in loaded and "benchmark" in loaded
    assert not loaded & set(harness.FORBIDDEN)
