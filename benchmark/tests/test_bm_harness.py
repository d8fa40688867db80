"""The harness on the CPU: it finds every piece by name, a cell added as new
files is found without an edit, and the whole suite takes a configuration
and a cell added as files alone; every driver runs to its outputs through
the program's plain versions, and no module it loads is JAX's.

    python -m pytest benchmark/tests
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import bounds, devtrace, harness, spans

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny(cell: harness.Cell):
    """The configuration's scale at the size its file gives the CPU tests
    (``cpu_test``), where the plain versions run in milliseconds."""
    c = cell.config["cpu_test"]
    return tuple(c["in_shape"]), tuple(c["out_shape"])


def test_every_piece_is_found_by_name():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and set(c["reduced"]) <= set(conf)
        assert c["file"].startswith("benchmark/configs/")
        harness.load(ROOT, "reference", conf["reference"]).check_semantics(conf)
        if conf["control"] is not None:
            harness.program_config(harness.control_config(conf))
        assert set(conf["cpu_test"]) == {"in_shape", "out_shape", "gap_lsb"}
    for name in CELLS:
        cell = harness.find_cell(name)
        drv = harness.load(ROOT, "drivers", cell.traffic["driver"])
        assert drv.Driver and drv.VALUES and drv.entry(cell.traffic)
        harness.program_config(cell.config)
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
    r = harness.execute(cell, 11, 0.05, False, device="cpu", shape=tiny(cell))
    assert r["correct"], r
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_a_configuration_and_a_cell_added_as_files_alone_pass_the_whole_suite(tmp_path):
    """In a copy of the benchmark, a configuration at another precision with
    no control, a reference of its own, a cut listed in ``reduced``, and a
    cell of it on the first cell's traffic, listed wherever that cell is,
    are added as new files and entries; the suite, run there, passes and
    edits no file that was there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bm = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bm.rglob("*") if p.is_file()}
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    like = spec["workloads"][0]
    entry = next(c for c in spec["configs"] if c["name"] == like["config"])
    conf = json.loads((ROOT / entry["file"]).read_text())
    name = f"{conf['name']}-bf16"
    # bf16 sums read 1.1-1.5 output levels from the exact value on the CPU
    conf.update(name=name, precision="bf16", control=None, reference="lanczos_copy",
                limits={"gap_lsb": 4.0}, cpu_test={**conf["cpu_test"], "gap_lsb": 2.0})
    (bm / "configs" / f"{name}.json").write_text(json.dumps(conf))
    shutil.copy(bm / "reference" / "lanczos.py", bm / "reference" / "lanczos_copy.py")
    spec["configs"].append({**entry, "name": name, "file": f"benchmark/configs/{name}.json",
                            "reduced": ["in_shape"], "why": "the same at bf16"})
    spec["workloads"].append({**like, "name": f"{like['name']}-bf16", "config": name})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like["name"] in m.get("workloads", []):
            m["workloads"].append(f"{like['name']}-bf16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    me = "benchmark/tests/test_bm_harness.py::" + sys._getframe().f_code.co_name
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(  # the program, after the copy
        [p for p in (os.environ.get("PYTHONPATH"), str(ROOT)) if p])}
    out = subprocess.run([sys.executable, "-m", "pytest", "benchmark/tests", "-q",
                          "-p", "no:cacheprovider", "--deselect", me],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


@pytest.mark.parametrize("name", CELLS)
def test_each_driver_runs_to_its_outputs_on_the_cpu(name):
    cell = harness.find_cell(name)
    r = harness.execute(cell, 2**31 + 5, 0.1, False, device="cpu", shape=tiny(cell))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "check"
    assert r["check"]["gap_lsb"]["value"] < cell.config["cpu_test"]["gap_lsb"]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_its_listed_metrics(name):
    cell = harness.find_cell(name)
    driver = harness.load(ROOT, "drivers", cell.traffic["driver"])
    values = {v: float(i + 1) for i, v in enumerate(driver.VALUES)}
    e2e = harness.end_to_end(cell, values, 7.0)
    assert set(e2e) == {m["name"] for m in harness.listed(SPEC, name, "end_to_end")}
    assert e2e["setup_s"]["value"] == 7.0
    for metric, v in e2e.items():
        # a metric named <value>.<tag> reports its driver's <value>
        if metric != "setup_s":
            assert v["value"] == values.get(metric, values.get(metric.split(".")[0])), metric
    # one host event of each program span, so that every span metric reads
    host = [devtrace.HostEvent(n, 0.3 + 0.05 * i, 0.32 + 0.05 * i) for i, n in enumerate(
        sorted(v for k, v in vars(spans).items() if k.isupper() and isinstance(v, str)))]
    t = devtrace.TraceSummary(1.0, list(range(cell.chips)), [
        devtrace.DeviceOp(d, k, n, 0.1, 0.2) for d in range(cell.chips) for k, n in (
            ("kernel", "fused_resample_kernel"), ("kernel", "elementwise_kernel"),
            ("memcpy_htod", "Memcpy HtoD"), ("memcpy_dtoh", "Memcpy DtoH"),
            ("memcpy_ptop", "Memcpy PtoP"))], host)
    bound = bounds.resample_bound(cell.config["in_shape"], cell.config["out_shape"],
                                  cell.config["a"], cell.config["channels"])
    pl = harness.per_layer(cell, harness.MetricInput(t, 100, bound, cell, None))
    assert set(pl) == {m["name"] for m in harness.listed(SPEC, name, "per_layer")}


def test_the_same_seed_gives_the_same_inputs():
    import torch

    cell = harness.find_cell(CELLS[0])
    drivers = []
    for seed in (9, 9, 10):
        cfg = harness.program_config(cell.config, tiny(cell))
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
            c = cell.config["cpu_test"]
            shape = (tuple(c["in_shape"]), tuple(c["out_shape"]))
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
