"""The yardstick on the CPU: the plain reference against a direct float64
sum, the independence from the program of every reference a configuration
names, the comparison's gap, the same judgement from a reference loaded by
the configuration's name as from one imported, the frozen bounds, and the
traced window's arithmetic on hand-made events."""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from benchmark import bounds, devtrace, harness
from benchmark.reference import lanczos as ref

CONF = harness.find_cell("perf8k-batch4-oncard").config
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in SPEC["configs"]]


def first_cell(config: str) -> harness.Cell:
    return harness.find_cell(next(w["name"] for w in SPEC["workloads"]
                                  if w["config"] == config))


def direct(img: np.ndarray, out_shape, a: int) -> np.ndarray:
    """Every output sample as one double sum over the 2a × 2a taps, with
    the kernel written out: a·sin(πt)·sin(πt/a) / (π²t²)."""

    def kernel(t):
        if t == 0:
            return 1.0
        return a * math.sin(math.pi * t) * math.sin(math.pi * t / a) / (math.pi ** 2 * t * t)

    def taps(y, n_in, n_out):
        x = y * n_in / n_out
        base = math.floor(x)
        w = [(min(max(i, 0), n_in - 1), kernel(x - i)) for i in range(base - a + 1, base + a + 1)]
        s = sum(v for _, v in w)
        return [(i, v / s) for i, v in w]

    (h, w), (oh, ow) = img.shape, out_shape
    out = np.zeros(out_shape)
    for y in range(oh):
        ty = taps(y, h, oh)
        for x in range(ow):
            tx = taps(x, w, ow)
            out[y, x] = sum(vy * vx * float(img[iy, ix]) for iy, vy in ty for ix, vx in tx)
    return out


@pytest.mark.parametrize("shape", [((6, 5), (12, 10)), ((4, 6), (6, 9)), ((5, 5), (5, 5))])
def test_reference_is_the_direct_float64_sum(shape):
    (h, w), out_shape = shape
    img = np.random.default_rng(h * 10 + w).integers(0, 256, (2, h, w), dtype=np.uint8)
    got = ref.exact(torch.from_numpy(img), CONF, out_shape).numpy()
    for p in range(2):
        np.testing.assert_allclose(got[p], direct(img[p], out_shape, 3), rtol=0, atol=1e-9)


def test_reference_keeps_a_constant_plane_and_refuses_what_it_does_not_compute():
    x = torch.full((1, 7, 9), 137, dtype=torch.uint8)
    np.testing.assert_allclose(ref.exact(x, CONF, (14, 18)).numpy(), 137.0, atol=1e-9)
    with pytest.raises(NotImplementedError):
        ref.exact(x, {**CONF, "dering": True}, (14, 18))
    with pytest.raises(NotImplementedError):
        ref.exact(x, CONF, (3, 4))


def test_gap_is_zero_on_the_truncated_bytes_and_the_distance_outside():
    r = torch.tensor([-3.0, 0.5, 12.0, 12.999, 254.2, 300.0], dtype=torch.float64)
    exact = torch.tensor([0, 0, 12, 12, 254, 255], dtype=torch.uint8)
    assert ref.gap_lsb(exact, r) == 0.0
    assert ref.gap_lsb(torch.tensor([0, 0, 13, 12, 254, 255], dtype=torch.uint8), r) == 1.0
    assert ref.gap_lsb(torch.tensor([0, 0, 12, 11, 254, 255], dtype=torch.uint8), r) == \
        pytest.approx(0.999)
    assert ref.gap_lsb(torch.tensor([0, 0, 12, 12, 254, 200], dtype=torch.uint8), r) == 99.0


@pytest.mark.parametrize("config", CONFIGS)
def test_the_reference_imports_nothing_of_the_program(config):
    conf = first_cell(config).config
    src = (harness.ROOT / "benchmark" / "reference" / f"{conf['reference']}.py").read_text()
    assert "lanczos_torch" not in src.replace("of the program", "")
    code = textwrap.dedent(f'''
        import importlib, sys, torch
        sys.path.insert(0, {str(harness.ROOT)!r})
        ref = importlib.import_module("benchmark.reference." + {conf["reference"]!r})
        ref.exact(torch.zeros((1, 4, 4), dtype=torch.uint8), {conf!r}, (8, 8))
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"lanczos_torch", *harness.FORBIDDEN}


@pytest.mark.parametrize("config", CONFIGS)
def test_judge_reads_the_same_gaps_from_the_reference_the_configuration_names(config):
    """Each sampled output of a CPU window judged with the reference loaded
    by the configuration's ``reference`` key and with the module imported
    by its package path: bit-identical gaps."""
    from .test_bm_harness import tiny

    cell = first_cell(config)
    conf = cell.config
    cfg = harness.program_config(conf, tiny(cell))
    ctx = harness.Context(cell, cfg, 2**31 + 29, [torch.device("cpu")] * cell.chips, False)
    drv = harness.load(harness.ROOT, "drivers", cell.traffic["driver"]).Driver(ctx)
    drv.setup()
    sampler = harness.Sampler(4, 2**31 + 29)
    drv.window(0.05, sampler)
    drv.release()
    named = harness.reference(cell)
    imported = importlib.import_module("benchmark.reference." + conf["reference"])
    assert named is not imported
    limit = conf["limits"]["gap_lsb"]
    for s in sampler.items():
        got = [harness.judge(drv, [s], r, conf, cfg.out_shape, torch.device("cpu"), limit)
               for r in (named, imported)]
        assert got[0] == got[1] and got[0]["checked"] == 1, got


def test_the_frozen_bounds_by_hand():
    b8 = bounds.resample_bound((2160, 3840), (4320, 7680), 3, 3)
    assert b8["bytes"] == 3 * (2160 * 3840 + 4320 * 7680) == 124_416_000
    assert b8["by"] == "bytes" and b8["seconds"] == pytest.approx(124.416e6 / 3.35e12)
    assert b8["flops"] == 2.0 * 3 * (4320 * 3840 * 6 + 4320 * 7680 * 6)
    b4 = bounds.resample_bound((1440, 2560), (2160, 3840), 3, 3)
    assert b4["bytes"] == 3 * (1440 * 2560 + 2160 * 3840) == 35_942_400
    assert b4["seconds"] * 1e3 == pytest.approx(0.010729, abs=1e-6)
    # a downscale's taps widen by D/N, so its operations can bound it
    assert bounds.resample_bound((4320, 7680), (270, 480), 3, 3)["flops"] == \
        2.0 * 3 * (270 * 7680 * 96 + 270 * 480 * 96)


def _ops():
    op = devtrace.DeviceOp
    return [op(0, "kernel", "void (anonymous namespace)::fused_resample_kernel<3>(int)", 0.1, 0.3),
            op(0, "kernel", "void at::native::elementwise_kernel<4>(int)", 0.25, 0.4),
            op(0, "memcpy_dtoh", "Memcpy DtoH (Device -> Pinned)", 0.6, 0.7),
            op(1, "memcpy_ptop", "Memcpy PtoP (Device -> Device)", 0.2, 0.3),
            op(1, "memcpy_htod", "Memcpy HtoD (Pinned -> Device)", 0.9, 1.0)]


def test_trace_arithmetic_on_hand_made_events():
    host = [devtrace.HostEvent("bench.call", 0.0, 0.5),
            devtrace.HostEvent("aten::copy_", 0.41, 0.45),
            devtrace.HostEvent("bench.next", 0.5, 1.0)]
    t = devtrace.TraceSummary(1.0, [0, 1], _ops(), host)
    assert t.busy_s(0) == pytest.approx(0.4) and t.busy_s(1) == pytest.approx(0.2)
    assert t.mean_busy_s() == pytest.approx(0.3)
    gaps = [(round(s, 6), round(n, 6)) for s, n in t.idle_gaps(0)]
    assert gaps == [(0.0, 0.1), (0.4, 0.2), (0.7, 0.3)]
    assert t.host_at(0.42) == "bench.call:aten::copy_" and t.host_at(0.75) == "bench.next:-"
    b = t.breakdown()
    assert b["device_ops"][0] == ["fused_resample_kernel", pytest.approx(0.2)]
    assert b["idle_gaps"][0] == ["cuda:1 bench.call:-", pytest.approx(0.6)]
    assert devtrace.kind_of("Memcpy PtoP (Device -> Device)") == "memcpy_ptop"
    assert devtrace.kind_of("Memset (Device)") == "memset"


def test_readers_on_hand_made_events():
    t = devtrace.TraceSummary(1.0, [0, 1], _ops(), [])
    cell = harness.find_cell("perf8k-batch4-oncard")
    bound = bounds.resample_bound((2160, 3840), (4320, 7680), 3, 3)
    m = harness.MetricInput(t, 1000, bound, cell, None)

    def read(name):
        return harness.load(harness.ROOT, "metrics", name).read(m)

    assert read("kernel.roofline_share") == pytest.approx(100 * 1000 * bound["seconds"] / 0.2)
    assert read("device.idle_share.call") == pytest.approx(60.0)
    assert read("device.idle_share.video") == pytest.approx(70.0)
    assert read("device.idle_share.video.4card") == pytest.approx(70.0)
    assert read("entry.layout_copy_ms_per_frame") == pytest.approx(0.15 / 1000 * 1e3)
    assert read("video.d2h_ms_per_frame") == pytest.approx(0.1)
    assert read("video.h2d_ms_per_frame") == pytest.approx(0.1)
    assert read("sharded.peer_copy_ms_per_frame") == pytest.approx(0.1)
    empty = harness.MetricInput(None, 0, bound, cell, None)
    for spec in cell.spec["per_layer"]:
        assert harness.load(harness.ROOT, "metrics", spec["name"]).read(empty) is None


def test_summarize_a_cpu_profile():
    with devtrace.session(cards=False) as got:
        with devtrace.annotate(devtrace.WINDOW):
            with devtrace.annotate("bench.call"):
                torch.ones(64).add_(1)
    t = devtrace.summarize(got[0], [0])
    assert t.window_s > 0 and t.ops == []
    assert any(h.name == "bench.call" for h in t.host)
