"""The span readers (``benchmark/spans.py`` and the eight metrics that read
the program's spans) on hand-built traced windows, and on a traced window
of each cell's driver on the CPU, where the program's spans reach the
summary on the driving thread.

    python -m pytest benchmark/tests/test_bm_spans.py
"""

from __future__ import annotations

import json

import pytest

from benchmark import devtrace, harness, spans

from .test_bm_harness import CELLS, ROOT, tiny

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# each span metric and the drivers whose window emits the spans it reads
# (the sharded span only on a mesh)
SPAN_METRICS = {
    "entry.host_ms_per_call": {"oncard"},
    "lane.host_copy_ms_per_frame": {"video"},
    "lane.submit_ms_per_frame": {"video"},
    "lane.wait_ms_per_frame": {"video"},
    "device.idle_in_host_copy_share.video": {"video"},
    "lane.wait_ms_per_frame.4card": {"video"},
    "sharded.host_ms_per_frame": {"video"},
    "device.idle_in_lane_wait_share.video.4card": {"video"},
}


def listed(cell: str) -> set:
    return {m["name"] for m in harness.listed(SPEC, cell, "per_layer")}


def read(name: str, trace, frames: int = 4):
    m = harness.MetricInput(trace, frames, {}, None, None)
    return harness.load(ROOT, "metrics", name).read(m)


def summary(host, ops=(), devices=(0,), window_s=1.0) -> devtrace.TraceSummary:
    host = sorted((devtrace.HostEvent(n, s, e) for n, s, e in host),
                  key=lambda h: (h.start, -h.end))
    return devtrace.TraceSummary(window_s, list(devices), [
        devtrace.DeviceOp(d, "kernel", "k", s, e) for d, s, e in ops], host)


def test_the_eight_metrics_are_listed_where_their_spans_are():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for name, drivers in SPAN_METRICS.items():
        m = by_name[name]
        assert m["source"] == "device_trace"
        assert m["better"] == "lower" and m["unit"] in ("ms", "%")
        for cell in CELLS:
            if name in listed(cell):
                assert harness.find_cell(cell).traffic["driver"] in drivers, (name, cell)


def test_the_span_names_are_the_programs():
    from lanczos_torch.utils import tracing

    for const in ("UPSCALE", "UPSCALER_CALL", "UPSCALER_PLANAR", "LANE_HOST_COPY",
                  "LANE_SUBMIT", "LANE_WAIT", "SHARDED_CALL"):
        assert getattr(spans, const) == getattr(tracing, const)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_window_without_the_span_reads_none(name):
    assert read(name, None) is None
    other = summary([("bench.call", 0.1, 0.2), ("aten::copy_", 0.3, 0.4),
                     ("lanczos_torch.lane.submitted", 0.5, 0.6)], ops=[(0, 0.0, 0.05)])
    assert read(name, other) is None


def test_ms_per_frame_sums_the_spans_clipped_to_the_window():
    t = summary([(spans.LANE_WAIT, -0.1, 0.1), (spans.LANE_WAIT, 0.5, 0.6),
                 (spans.LANE_WAIT, 0.95, 1.2), (spans.LANE_SUBMIT, 0.2, 0.3)])
    assert read("lane.wait_ms_per_frame", t, 4) == pytest.approx((0.1 + 0.1 + 0.05) / 4 * 1e3)
    assert read("lane.submit_ms_per_frame", t, 4) == pytest.approx(0.1 / 4 * 1e3)
    assert read("lane.wait_ms_per_frame", t, 0) is None


def test_the_entry_reads_the_outermost_span_of_each_call():
    # upscale ⊃ upscaler.call twice; a bare planar call (⊃ a fallback call)
    t = summary([(spans.UPSCALE, 0.10, 0.20), ("aten::view", 0.11, 0.12),
                 (spans.UPSCALER_CALL, 0.15, 0.19),
                 (spans.UPSCALE, 0.30, 0.34), (spans.UPSCALER_CALL, 0.31, 0.33),
                 (spans.UPSCALER_PLANAR, 0.50, 0.56), (spans.UPSCALER_CALL, 0.51, 0.55)])
    assert read("entry.host_ms_per_call", t) == pytest.approx((0.10 + 0.04 + 0.06) / 3 * 1e3)
    # the time blocked on a full launch queue inside a call is not the host's own
    blocked = summary(
        [(spans.UPSCALER_PLANAR, 0.10, 0.20), ("cudaLaunchKernel", 0.12, 0.19),
         (spans.BLOCKED, 0.13, 0.18), (spans.UPSCALER_PLANAR, 0.30, 0.34),
         (spans.BLOCKED, 0.40, 0.45)])  # outside every call
    assert read("entry.host_ms_per_call", blocked) == pytest.approx((0.05 + 0.04) / 2 * 1e3)
    assert spans.outermost([(0.0, 1.0), (0.0, 0.5), (0.2, 0.3), (1.0, 2.0)]) == [
        (0.0, 1.0), (1.0, 2.0)]


def test_the_idle_share_inside_a_spans_union():
    # the card runs 0.2–0.4 and 0.6–0.7 of a 1 s window: idle 0–0.2, 0.4–0.6
    # and 0.7–1.0 (0.7 s), two of the gaps at the window's edges
    ops = [(0, 0.2, 0.3), (0, 0.25, 0.4), (0, 0.6, 0.7)]
    hc = [(spans.LANE_HOST_COPY, 0.1, 0.3), (spans.LANE_HOST_COPY, 0.15, 0.25),  # overlapping
          (spans.LANE_HOST_COPY, 0.45, 0.5), (spans.LANE_HOST_COPY, 0.9, 1.5)]  # past the end
    t = summary(hc, ops=ops)
    inside = 0.1 + 0.05 + 0.1  # 0.1–0.2, 0.45–0.5, 0.9–1.0
    assert read("device.idle_in_host_copy_share.video", t) == pytest.approx(
        100 * inside / 0.7)
    assert spans.overlap_s([(0.0, 0.2), (0.4, 0.6)], [[0.1, 0.5]]) == pytest.approx(0.2)


def test_the_idle_share_over_four_cards_is_their_mean():
    # card 0 busy 0–0.5 (idle 0.5–1.0), cards 1–3 never busy; the host waits 0.6–0.8
    t = summary([(spans.LANE_WAIT, 0.6, 0.8)], ops=[(0, 0.0, 0.5)], devices=(0, 1, 2, 3))
    want = (100 * 0.2 / 0.5 + 3 * 100 * 0.2 / 1.0) / 4
    assert read("device.idle_in_lane_wait_share.video.4card", t) == pytest.approx(want)
    assert read("lane.wait_ms_per_frame.4card", t, 2) == pytest.approx(0.2 / 2 * 1e3)
    # a card that is never idle gives no share; with none idle, none at all
    full = summary([(spans.LANE_WAIT, 0.6, 0.8)], ops=[(0, 0.0, 1.0)])
    assert read("device.idle_in_host_copy_share.video", full) is None
    assert read("device.idle_in_lane_wait_share.video.4card", full) is None


@pytest.mark.parametrize("name", CELLS)
def test_each_cells_span_metrics_read_the_programs_spans_on_the_cpu(name):
    """A traced window of the cell's driver on the CPU, summarized as on the
    card: every span metric listed for the cell reads a number."""
    import torch

    cell = harness.find_cell(name)
    cfg = harness.program_config(cell.config, tiny(cell))
    ctx = harness.Context(cell, cfg, 2**31 + 7, [torch.device("cpu")] * cell.chips, False)
    drv = harness.load(ROOT, "drivers", cell.traffic["driver"]).Driver(ctx)
    drv.setup()
    ctx.traced = True
    with devtrace.session(False) as got:
        win = drv.window(0.2, harness.Sampler(1, 1))
    t = devtrace.summarize(got[0], list(range(cell.chips)))
    m = harness.MetricInput(t, win.frames, {}, cell, cfg)
    for metric in set(SPAN_METRICS) & listed(name):
        value = harness.load(ROOT, "metrics", metric).read(m)
        assert value is not None and value >= 0.0, metric
        if "share" in metric:
            assert value <= 100.0
