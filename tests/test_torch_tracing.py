"""``lanczos_torch.utils.tracing`` on the CPU: with the profiler off a span
site builds nothing; under ``torch.profiler`` the entry, the lane and the
sharded call record their spans, once a call and nested as the layers
are, and a fused launch (the library stubbed) the span of the kernel its
geometry routes it to; the outputs do not change; ``profiling.trace``
writes each call's Chrome trace, spans included, into a directory of its
own.  On a card, an 8K bf16 planar call records one ring span."""

import contextlib
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import _build  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402
from lanczos_torch.parallel.sharded import ShardedUpscaler  # noqa: E402
from lanczos_torch.utils import profiling, tracing  # noqa: E402

SHAPE = (16, 12)
ENTRY = (tracing.UPSCALE, tracing.UPSCALER_CALL, tracing.UPSCALER_PLANAR)


def _cfg():
    return lanczos_torch.ResampleConfig.from_profile("precise", SHAPE, scale=(2, 1), a=2)


def _frames(t, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (t,) + SHAPE + (3,), dtype=np.uint8)


def _spans(prof) -> list:
    """``(name, start_ns, end_ns)`` of the port's spans, by start (an
    enclosing span before the spans it encloses)."""
    out = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.name().startswith("lanczos_torch.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _run_all():
    """Every span site once or more, on the CPU: the outputs."""
    cfg = _cfg()
    frames = _frames(5)
    model = lanczos_torch.Upscaler(cfg, device="cpu")
    x = torch.from_numpy(frames)
    mesh = Mesh.local(["cpu"] * 2, (2, 1))
    return [
        model(x[0]),
        model.planar(x[:2].permute(0, 3, 1, 2)),
        lanczos_torch.upscale(x[1], out_shape=cfg.out_shape, a=2, device="cpu"),
        np.stack(list(lanczos_torch.VideoUpscaler(cfg, batch=2, depth=2,
                                                  device="cpu").frames(frames))),
        ShardedUpscaler(cfg, mesh)(x[:2]),
    ]


def test_the_profiler_flag_the_spans_read_exists():
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
    assert profiler._is_profiler_enabled is False
    p = profile(activities=[ProfilerActivity.CPU])  # as the benchmark starts one
    p.start()
    try:
        assert profiler._is_profiler_enabled is True
    finally:
        p.stop()
    assert profiler._is_profiler_enabled is False


def test_off_a_span_is_one_shared_object_and_no_site_builds_a_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was built with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    spans = {id(tracing.span(name)) for name in ENTRY + (tracing.LANE_WAIT, "x")}
    assert len(spans) == 1
    with tracing.span(tracing.LANE_SUBMIT) as got:
        assert got is None
    assert len(_run_all()) == 5


@pytest.mark.parametrize("entry,name", [
    ("call", tracing.UPSCALER_CALL),
    ("planar", tracing.UPSCALER_PLANAR),
    ("upscale", tracing.UPSCALE),
])
def test_the_entry_records_one_outermost_span_a_call(entry, name):
    cfg = _cfg()
    x = torch.from_numpy(_frames(3))
    model = lanczos_torch.Upscaler(cfg, device="cpu")
    fn = {"call": model,
          "planar": lambda f: model.planar(f.permute(2, 0, 1)),
          "upscale": lambda f: lanczos_torch.upscale(f, out_shape=cfg.out_shape, a=2,
                                                     device="cpu")}[entry]
    _, spans = _traced(lambda: [fn(f) for f in x])
    outer = [s for s in spans if s[0] == name]
    assert len(outer) == 3
    for s in spans:  # every other entry span lies inside one of the call's
        assert s[0] in ENTRY and (s in outer or any(_inside(s, o) for o in outer))
    if entry == "upscale":  # the public entry encloses the cached model's call
        inner = [s for s in spans if s[0] == tracing.UPSCALER_CALL]
        assert len(inner) == 3 and all(_inside(i, o) for i, o in zip(inner, outer))


def test_the_video_lane_records_its_spans_in_submit_order():
    cfg = _cfg()
    vu = lanczos_torch.VideoUpscaler(cfg, batch=2, depth=2, device="cpu")
    frames = _frames(5)
    _, spans = _traced(lambda: list(vu.frames(frames)))
    lane = [s for s in spans if s[0].startswith("lanczos_torch.lane.")]
    hc, sub, wait = tracing.LANE_HOST_COPY, tracing.LANE_SUBMIT, tracing.LANE_WAIT
    # 5 frames in stacks of 2, 2 and 1; the first pop once 2 are in flight
    assert [s[0] for s in lane] == [hc, hc, sub, hc, hc, sub, wait, hc, sub, wait, wait]
    submits = [s for s in lane if s[0] == sub]
    waits = [s for s in lane if s[0] == wait]
    assert all(w[1] >= s[2] for s, w in zip(submits, waits))
    # the model runs inside its submit (a CPU lane runs it at once)
    calls = [s for s in spans if s[0] == tracing.UPSCALER_CALL]
    assert len(calls) == 3 and all(_inside(c, s) for c, s in zip(calls, submits))


def test_the_sharded_call_records_one_span_a_call():
    cfg = _cfg()
    model = ShardedUpscaler(cfg, Mesh.local(["cpu"] * 2, (2, 1)))
    x = torch.from_numpy(_frames(2))
    _, spans = _traced(lambda: [model(x), model(x)])
    assert [s[0] for s in spans] == [tracing.SHARDED_CALL] * 2


def test_the_outputs_are_byte_equal_with_the_profiler_on_and_off():
    off = _run_all()
    on, spans = _traced(_run_all)
    assert {s[0] for s in spans} == set(ENTRY) | {
        tracing.LANE_HOST_COPY, tracing.LANE_SUBMIT, tracing.LANE_WAIT, tracing.SHARDED_CALL}
    for a, b in zip(off, on):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_trace_writes_each_call_into_a_directory_of_its_own(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    model = lanczos_torch.Upscaler(_cfg(), device="cpu")
    x = torch.from_numpy(_frames(1)[0])
    dirs = []
    for _ in range(2):
        with profiling.trace() as logdir:
            model(x)
        dirs.append(Path(logdir))
    assert dirs[0] != dirs[1] and all(d.parent == tmp_path for d in dirs)
    assert all(d.name.startswith("lanczos_torch_trace_") for d in dirs)
    for d in dirs:
        names = {e.get("name") for e in json.loads((d / "trace.json").read_text())["traceEvents"]}
        assert tracing.UPSCALER_CALL in names


class _Library:
    """The kernels' library with the launch stubbed: it records each
    launch's ``(stages, blocks)`` and writes nothing."""

    def __init__(self):
        self.routes = []

    def lanczos_fused_resample(self, *args):
        self.routes.append(args[-3:-1])
        return 0


def _ops_as_on_a_card(in_shape, out_shape):
    """A bf16 config's ``FusedOps`` on the CPU holding what a card's would
    hold: its planar layout, uploaded to the CPU by ``upload_layout``."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", in_shape, out_shape=out_shape,
                                                    a=3, precision="bf16")
    ops = rc.FusedOps(cfg, "cpu")
    ops.layouts[1] = rc.upload_layout(ops.plan, cfg, "cpu")
    return ops


@pytest.mark.parametrize("route,in_shape,out_shape", [
    ("ring", (16, 32), (32, 64)),  # widths of whole 16-byte rows: the TMA ring
    ("tile", (16, 20), (32, 40)),  # 20-byte input rows: the one-tile kernel
])
def test_a_fused_launch_records_the_span_of_its_route_while_profiling(
        route, in_shape, out_shape, monkeypatch):
    assert (tracing.FUSED_RING, tracing.FUSED_TILE) == (
        "lanczos_torch.fused.ring", "lanczos_torch.fused.tile")
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(rc, "launches", dict(rc.launches))
    monkeypatch.setattr(rc, "pipelined", dict(rc.pipelined))
    monkeypatch.setattr(rc, "interleaved", dict(rc.interleaved))
    ops = _ops_as_on_a_card(in_shape, out_shape)
    x = torch.randint(0, 256, (3,) + in_shape, dtype=torch.uint8)
    out = torch.empty((3,) + out_shape, dtype=torch.uint8)

    _, spans = _traced(lambda: rc._launch(ops, x, out, ops.layout()))
    want = {"ring": tracing.FUSED_RING, "tile": tracing.FUSED_TILE}[route]
    assert [s[0] for s in spans] == [want]
    assert (lib.routes[0][0] > 0) == (route == "ring")

    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was built with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rc._launch(ops, x, out, ops.layout())
    assert len(lib.routes) == 2 and rc.launches[ops.kernel] == 2
    assert rc.pipelined[ops.kernel] == 2 * (route == "ring")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_an_8k_bf16_planar_call_records_one_ring_span(card):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (2160, 3840), scale=(2, 1), a=3,
                                                    precision="bf16")
    model = lanczos_torch.Upscaler(cfg, backend="auto", device="cuda")
    x = torch.randint(0, 256, (1, 3, 2160, 3840), dtype=torch.uint8, device="cuda")
    model.planar(x)  # builds the kernels and uploads the tables
    torch.cuda.synchronize()
    _, spans = _traced(lambda: model.planar(x))
    torch.cuda.synchronize()
    assert [s[0] for s in spans if s[0].startswith("lanczos_torch.fused.")] == [tracing.FUSED_RING]
