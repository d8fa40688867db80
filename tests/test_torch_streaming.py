"""``lanczos_torch.StreamingUpscaler`` on the CPU (the kernels' plain
versions) against ``lanczos_tpu``'s on the same seeded inputs.

Limits: the fused chunk path on the JAX object's own chunk plan against
the JAX ``chunk_backend="mxu"`` result (the Pallas kernel in interpret
mode) under ``test_torch_fused.py``'s limits (fp32 ≤ 1 LSB on ≤ 1% of
pixels; the port's bf16 against the JAX fp32 ≤ 3 LSB on ≤ 50%); on its own
plan ≤ 1 LSB against the JAX whole-frame gather (the reference's own
contract for this path; bf16 ≤ 3 LSB on ≤ 50%); the gather and shift
chunk paths identical bytes to the port's whole-frame gather, and within
``test_torch_gather.py``'s limits (≤ 1 LSB on ≤ 1%) of the JAX streaming
result; pipelined and resumed runs identical bytes to serial and full
ones.
"""

import functools
import re
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.models.streaming import StreamingUpscaler as TpuStreaming  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.models import streaming as st  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}
INS = (96, 64)
# the reference's seven fused-chunk families (tests/test_streaming.py): out, overrides, chunk
FAMILIES = {
    "2x": ((192, 128), {}, 32),
    "3/2": ((144, 96), {}, 24),
    "1/2": ((48, 32), {}, 16),
    "reflect": ((192, 128), {"edge_mode": "reflect"}, 32),
    "dering": ((192, 128), {"dering": True}, 32),
    "quantize": ((192, 128), {"intermediate_quantize": True}, 32),
    "center": ((192, 128), {"align": "center"}, 32),
}


def _cfgs(name, precision="fp32", ins=INS):
    outs, kw, chunk = FAMILIES[name]
    args = dict(out_shape=outs, a=3, **kw)
    return (lanczos_torch.ResampleConfig.from_profile("precise", ins, precision=precision,
                                                      **args),
            lanczos_tpu.ResampleConfig.from_profile("precise", ins, **args), chunk)


def _img(shape=INS, seed=42, channels=3):
    return np.random.default_rng(seed).integers(0, 256, shape + (channels,), dtype=np.uint8)


def _within(got, want, precision):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    lim, frac_lim = LIMITS[precision]
    assert d.max() <= lim and (d > 0).mean() <= frac_lim, (d.max(), (d > 0).mean())


@functools.lru_cache(maxsize=None)
def _tpu_mxu(name):
    """The JAX fused chunk path (interpret mode) on the family's image: the
    object and its whole-frame output."""
    _, tcfg, chunk = _cfgs(name)
    sm = TpuStreaming(tcfg, chunk_rows=chunk, chunk_backend="mxu")
    assert sm.use_mxu
    return sm, sm(_img())


@functools.lru_cache(maxsize=None)
def _tpu_gather(name):
    _, tcfg, _ = _cfgs(name)
    return np.asarray(lanczos_tpu.Upscaler(tcfg, backend="xla")(_img()))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_fused_chunks_on_the_jax_chunk_plan_match_jax_mxu(name, precision):
    cfg, _, chunk = _cfgs(name, precision)
    tsm, want = _tpu_mxu(name)
    sm = lanczos_torch.StreamingUpscaler.from_reference(
        cfg, chunk, vars(tsm._mxu.mxu), tsm.win, tsm.mxu_row0_base, tsm.mxu_row0_step,
        device="cpu")
    assert sm.chunk_path == "fused" and sm.win == tsm.win
    np.testing.assert_array_equal(sm._mxu.plan.starts_v, tsm._mxu.mxu.starts_v)
    _within(sm(_img()), want, precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_fused_chunks_on_own_plan_within_1_lsb_of_jax_gather(name, precision):
    cfg, _, chunk = _cfgs(name, precision)
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, chunk_backend="mxu",
                                         device="cpu")
    assert sm.chunk_path == "fused"
    got, want = sm(_img()), _tpu_gather(name)
    if precision == "fp32":
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        _within(got, want, "bf16")
    # "auto" takes the fused path wherever its gates pass, on the CPU too
    auto = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, device="cpu")
    assert auto.chunk_path == "fused"
    np.testing.assert_array_equal(auto(_img()), got)


@pytest.mark.parametrize("backend", ["mxu", "shift", "gather"])
@pytest.mark.parametrize("name", FAMILIES)
def test_chunk_geometry_equals_the_jax_objects(name, backend):
    cfg, tcfg, chunk = _cfgs(name)
    try:
        tsm = TpuStreaming(tcfg, chunk_rows=chunk, chunk_backend=backend)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, chunk_backend=backend,
                                            device="cpu")
        return
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, chunk_backend=backend,
                                         device="cpu")
    assert sm.chunk_path == {"mxu": "fused"}.get(backend, backend)
    assert (sm.spans, sm.win, sm.chunk, sm.n_chunks) == (
        tsm.spans, tsm.win, tsm.chunk, tsm.n_chunks)
    if backend == "mxu":
        assert (sm.mxu_row0_base, sm.mxu_row0_step) == (
            tsm.mxu_row0_base, tsm.mxu_row0_step)
    if backend == "shift":
        assert sm.w0_step == tsm.w0_step


GATED = [  # (in, args, chunk): where the reference's fused chunk path refuses
    ((96, 64), dict(scale=(2, 1), edge_mode="drop", normalize=True), 32),
    ((96, 64), dict(scale=(2, 1), edge_mode="drop", normalize=False), 32),
    ((96, 64), dict(scale=(2, 1), dering=True, order="width_first"), 32),
    ((96, 64), dict(scale=(2, 1), intermediate_quantize=True, order="width_first"), 32),
    ((96, 64), dict(scale=(2, 1)), 2),  # the slice touches the virtual edges
    ((12, 64), dict(scale=(2, 1)), 512),  # the window is taller than the frame
]


@pytest.mark.parametrize("ins,args,chunk", GATED)
def test_fused_gates_raise_where_the_reference_raises(ins, args, chunk):
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", ins, a=3, **args)
    with pytest.raises(NotImplementedError):
        TpuStreaming(tcfg, chunk_rows=chunk, chunk_backend="mxu")
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", ins, a=3, **args)
    with pytest.raises(NotImplementedError, match="fused chunk path"):
        lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, chunk_backend="mxu",
                                        device="cpu")
    # auto falls to another chunk path there: routing, and it says which
    auto = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, device="cpu")
    assert auto.chunk_path in ("shift", "gather")
    want = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(
        torch.from_numpy(_img(ins))).numpy()
    np.testing.assert_array_equal(auto(_img(ins)), want)


def test_a_linear_width_first_config_passes_the_gates():
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", INS, scale=(2, 1), a=3, order="width_first")
    sm = lanczos_torch.StreamingUpscaler(cfg, 32, chunk_backend="mxu", device="cpu")
    want = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(
        torch.from_numpy(_img())).numpy()
    assert np.abs(sm(_img()).astype(int) - want.astype(int)).max() <= 1


def test_bad_arguments():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", INS, scale=(2, 1))
    with pytest.raises(ValueError, match="chunk_backend"):
        lanczos_torch.StreamingUpscaler(cfg, chunk_backend="pallas", device="cpu")
    for profile in ("hls", "c_oracle"):
        fixed = lanczos_torch.ResampleConfig.from_profile(profile, INS, scale=(2, 1), a=2)
        with pytest.raises(NotImplementedError, match="precise"):
            lanczos_torch.StreamingUpscaler(fixed, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lanczos_torch.StreamingUpscaler(cfg)  # device="cuda" by default


@pytest.mark.parametrize("scale", [(2, 1), (3, 2), (7, 2)])
@pytest.mark.parametrize("chunk", [8, 20, 64])
@pytest.mark.parametrize("backend", ["gather", "shift"])
def test_gather_and_shift_chunks_equal_the_whole_frame_gather(scale, chunk, backend):
    n, d = scale
    h, w = 16 * d, 8 * d
    args = dict(scale=scale, a=3)
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (h, w), **args)
    img = _img((h, w))
    want = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(
        torch.from_numpy(img)).numpy()
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, chunk_backend=backend,
                                         device="cpu")
    assert sm.chunk_path == backend and sm.n_chunks == -(-h * n // d // sm.chunk)
    got = sm(img)
    np.testing.assert_array_equal(got, want)
    tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", (h, w), **args)
    _within(got, TpuStreaming(tcfg, chunk_rows=chunk, chunk_backend=backend)(img), "fp32")


@pytest.mark.parametrize("backend,kw", [
    ("gather", dict(dering=True, edge_mode="reflect")),
    ("shift", dict(dering=True, edge_mode="reflect")),
    ("gather", dict(edge_mode="drop")),
    ("shift", dict(edge_mode="drop", normalize=False)),
    ("gather", dict(intermediate_quantize=True, order="width_first", dering=True)),
    ("gather", dict(align="center", order="width_first")),
    ("shift", dict(align="center")),
    ("gather", dict(precision="bf16")),
    ("shift", dict(precision="bf16", dering=True)),
])
def test_gather_and_shift_chunk_semantics(backend, kw):
    """Edges, dering, the quantized intermediate, both pass orders and
    bf16 (taken from ``cfg.precision``) through the chunk paths."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (32, 12), scale=(2, 1), a=2,
                                                    **kw)
    img = _img((32, 12), seed=5)
    want = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(
        torch.from_numpy(img)).numpy()
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=8, chunk_backend=backend,
                                         device="cpu")
    assert sm.chunk_path == backend
    assert sm.dtype == (torch.bfloat16 if "precision" in kw else torch.float32)
    np.testing.assert_array_equal(sm(img), want)


def test_shift_gate():
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", (32, 12), scale=(2, 1), a=2, intermediate_quantize=True)
    with pytest.raises(NotImplementedError, match="shift chunk path"):
        lanczos_torch.StreamingUpscaler(cfg, 8, chunk_backend="shift", device="cpu")


@pytest.mark.parametrize("backend", ["mxu", "shift", "gather"])
def test_resume_equals_the_tail_of_a_full_run(backend):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (64, 16), scale=(2, 1), a=2)
    img = _img((64, 16))
    model = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=16, chunk_backend=backend,
                                            device="cpu")
    full = dict(model.chunks(lambda lo, hi: img[lo:hi]))
    for depth in (1, 2):
        resumed = dict(model.chunks(lambda lo, hi: img[lo:hi], start_chunk=2, depth=depth))
        assert list(resumed) == [y0 for y0 in full if y0 >= 2 * model.chunk]
        for y0, chunk in resumed.items():
            np.testing.assert_array_equal(chunk, full[y0])
    assert list(model.chunks(lambda lo, hi: img[lo:hi], start_chunk=model.n_chunks)) == []


@pytest.mark.parametrize("backend", ["mxu", "shift", "gather"])
def test_rows_are_fetched_lazily(backend):
    """get_rows is asked once a chunk, only for the window it needs."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (64, 16), scale=(2, 1), a=2)
    img = _img((64, 16))
    model = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=16, chunk_backend=backend,
                                            device="cpu")
    calls = []

    def get_rows(lo, hi):
        calls.append((lo, hi))
        return img[lo:hi]

    list(model.chunks(get_rows))
    assert len(calls) == model.n_chunks
    assert all(0 <= lo < hi <= 64 and hi - lo <= model.win for lo, hi in calls)
    assert model.win <= 16 // 2 + 2 * cfg.a + 2


@pytest.mark.parametrize("backend", ["mxu", "shift", "gather"])
def test_pipelined_equals_serial(backend):
    """depth > 1 with the threaded prefetch: identical bytes to the serial
    path, in order, get_rows called in ascending order and never
    re-entered; arrays yielded earlier stay valid while later chunks run."""
    img = _img((96, 40))
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (96, 40), scale=(3, 2), a=3)
    s = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=24, chunk_backend=backend,
                                        device="cpu")
    assert s.chunk_path == {"mxu": "fused"}.get(backend, backend)
    calls, threads = [], set()
    lock = threading.Lock()
    busy = [False]

    def get_rows(lo, hi):
        with lock:
            assert not busy[0], "get_rows re-entered concurrently"
            busy[0] = True
        calls.append((lo, hi))
        threads.add(threading.get_ident())
        rows = img[lo:hi]
        with lock:
            busy[0] = False
        return rows

    serial = list(s.chunks(lambda lo, hi: img[lo:hi], depth=1, prefetch=False))
    piped = list(s.chunks(get_rows, depth=3, prefetch=True))
    assert [y for y, _ in piped] == [y for y, _ in serial] == [
        k * s.chunk for k in range(s.n_chunks)]
    for (_, a), (_, b) in zip(serial, piped):
        assert a.dtype == np.uint8 and a.shape == (min(s.chunk, 144), 60, 3)
        np.testing.assert_array_equal(a, b)
    los = [lo for lo, _ in calls]
    assert los == sorted(los) and len(calls) == s.n_chunks
    assert len(threads) == 2  # the first window on the caller's thread, the rest on one worker
    np.testing.assert_array_equal(np.concatenate([c for _, c in piped]), s(img))
    threads.clear()
    list(s.chunks(get_rows, depth=2, prefetch=False))
    assert threads == {threading.get_ident()}


def test_tail_chunk_and_other_channel_counts():
    """A ragged last chunk yields only its valid rows; the channel count
    is the window's, not the config's."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (50, 24), scale=(2, 1), a=3)
    for backend in ("mxu", "shift", "gather"):
        sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=32, chunk_backend=backend,
                                             device="cpu")
        assert sm.n_chunks == 4 and sm.chunk == 32
        for channels in (1, 4):
            img = _img((50, 24), seed=3, channels=channels)
            chunks = list(sm.chunks(lambda lo, hi: img[lo:hi]))
            assert [c.shape for _, c in chunks] == [(32, 48, channels)] * 3 + [
                (4, 48, channels)]
            want = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(
                torch.from_numpy(img)).numpy()
            got = np.concatenate([c for _, c in chunks])
            assert np.abs(got.astype(int) - want.astype(int)).max() <= (backend == "mxu")


def test_abandoned_generator_joins_its_worker():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (64, 16), scale=(2, 1), a=2)
    img = _img((64, 16))
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=16, device="cpu")
    running = threading.Event()

    def get_rows(lo, hi):
        running.set()
        try:
            return img[lo:hi]
        finally:
            running.clear()

    before = threading.active_count()
    g = sm.chunks(get_rows, depth=1)
    assert next(g)[0] == 0
    g.close()  # abandon: nothing of get_rows may still run afterwards
    assert not running.is_set()
    assert threading.active_count() <= before + 1


@pytest.mark.parametrize("prefetch", [True, False])
def test_a_raising_get_rows_reraises_at_the_consumer(prefetch):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (64, 16), scale=(2, 1), a=2)
    img = _img((64, 16))
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=16, device="cpu")

    def get_rows(lo, hi):
        if lo > 20:
            raise OSError("decoder died")
        return img[lo:hi]

    got = []
    with pytest.raises(OSError, match="decoder died"):
        for y0, _ in sm.chunks(get_rows, depth=2, prefetch=prefetch):
            got.append(y0)
    assert got == sorted(got) and len(got) < sm.n_chunks


def test_a_hand_built_plan_with_a_shifted_offset_goes_through_fused_call():
    """The launcher feature the chunk path rests on: ``fused_call`` on a plan
    built from a window-rebased operator and ``off_eff``; every tap of every
    tile lies inside its band, at a center-aligned downscale too."""
    for name, ins in (("2x", INS), ("1/2", INS), ("center", INS), ("3/2", (192, 64))):
        outs, kw, chunk = FAMILIES[name]
        outs = (outs[0] * ins[0] // INS[0], outs[1])
        cfg = lanczos_torch.ResampleConfig.from_profile("precise", ins, out_shape=outs, a=3,
                                                        **kw)
        sm = lanczos_torch.StreamingUpscaler(cfg, chunk, chunk_backend="mxu", device="cpu")
        ops, plan = sm._mxu, sm._mxu.plan
        assert ops.cfg.in_shape == (sm.win, ins[1]) and ops.cfg.out_shape == (sm.chunk, outs[1])
        assert plan.starts_v.min() >= 0 and (plan.starts_v + plan.kv).max() <= max(sm.win, plan.kv)
        x = torch.from_numpy(_img((sm.win, ins[1]), seed=9).transpose(2, 0, 1).copy())
        before = dict(rc.launches)
        y = rc.fused_call(ops, x)
        assert y.shape == (3, sm.chunk, outs[1]) and rc.launches == before
        # the chunk plan's own vertical tables through wv= give the same bytes
        tables = rc.vertical_tables(plan, cfg.precision, "cpu")
        assert torch.equal(rc.fused_call(ops, x, wv=tables), y)
        with pytest.raises(TypeError, match="VerticalTables"):
            rc.fused_call(ops, x, wv=(plan.wv,))
        # an interior chunk's rows are the whole-frame rows from the same window
        k = 1
        w0 = sm.mxu_row0_base + k * sm.mxu_row0_step
        img = _img(ins, seed=10)
        assert 0 <= w0 and w0 + sm.win <= ins[0]
        y = rc.fused_call(ops, torch.from_numpy(
            img[w0 : w0 + sm.win].transpose(2, 0, 1).copy()))
        want = lanczos_torch.Upscaler(cfg, backend="xla", device="cpu")(
            torch.from_numpy(img)).numpy()[k * sm.chunk : (k + 1) * sm.chunk]
        assert np.abs(y.permute(1, 2, 0).numpy().astype(int) - want.astype(int)).max() <= 1


def test_the_port_imports_no_jax():
    """No module of the port imports ``jax`` or ``lanczos_tpu``."""
    root = Path(lanczos_torch.__file__).parent
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|lanczos_tpu)\b", re.M)
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert {"streaming.py", "video.py", "_pipeline.py", "y4m.py"} <= {f.name for f in files}
    for path in files:
        assert not pattern.search(path.read_text()), path
    assert st.StreamingUpscaler is lanczos_torch.StreamingUpscaler


@pytest.mark.parametrize("backend", ["mxu", "shift", "gather"])
@pytest.mark.parametrize("rows,depth", [(2, 2), (4, 1), (4, 3)])
def test_sharded_streaming_equals_streaming(backend, rows, depth):
    """ShardedStreamingUpscaler: super-chunks of R sub-chunks, each running
    the single-device chunk program on its window: identical chunks, in
    order, to StreamingUpscaler's; resumable at multiples of R only."""
    from lanczos_torch.parallel.mesh import Mesh

    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (200, 48), scale=(2, 1), a=3)
    img = _img((200, 48), seed=11)
    base = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=32, chunk_backend=backend,
                                           device="cpu")
    want = list(base.chunks(lambda lo, hi: img[lo:hi]))
    sm = lanczos_torch.ShardedStreamingUpscaler(
        cfg, Mesh.local(["cpu"] * rows, (1, rows)), chunk_rows=32, chunk_backend=backend)
    assert sm.chunk_path == base.chunk_path and sm.n_groups == -(-sm.n_chunks // rows)
    got = list(sm.chunks(lambda lo, hi: img[lo:hi], depth=depth))
    assert [y for y, _ in got] == [y for y, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    np.testing.assert_array_equal(sm(img), base(img))
    resumed = list(sm.chunks(lambda lo, hi: img[lo:hi], start_chunk=rows))
    assert [y for y, _ in resumed] == [y for y, _ in want[rows:]]
    with pytest.raises(ValueError, match="multiple of the rows-axis size"):
        list(sm.chunks(lambda lo, hi: img[lo:hi], start_chunk=1))


def test_sharded_streaming_against_jax_and_refusals():
    """The gather chunk path against the JAX ShardedStreamingUpscaler
    (≤ 1 LSB on ≤ 1%), and what the sharded stream refuses."""
    import jax

    from lanczos_tpu.models.streaming import ShardedStreamingUpscaler as TpuSharded
    from lanczos_torch.parallel.mesh import Mesh

    cfg, tcfg, _ = _cfgs("3/2", ins=(96, 64))
    img = _img((96, 64), seed=12)
    sm = lanczos_torch.ShardedStreamingUpscaler(cfg, Mesh.local(["cpu"] * 4, (4,), ("rows",)),
                                                chunk_rows=24, chunk_backend="gather")
    tsm = TpuSharded(tcfg, jax.make_mesh((4,), ("rows",)), chunk_rows=24,
                     chunk_backend="gather")
    assert (sm.R, sm.n_groups, sm.win) == (tsm.R, tsm.n_groups, tsm.win)
    _within(sm(img), tsm(img), "fp32")
    with pytest.raises(TypeError, match="Mesh"):
        lanczos_torch.ShardedStreamingUpscaler(cfg, object())
    with pytest.raises(ValueError, match="no axis 'rows'"):
        lanczos_torch.ShardedStreamingUpscaler(cfg, Mesh.local(["cpu"] * 2, (2,), ("data",)))
