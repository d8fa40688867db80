"""``lanczos_torch.VideoUpscaler`` on the CPU against per-frame
``Upscaler`` calls of both packages, on the same seeded frames.

Limits: each frame identical bytes to the port's ``Upscaler`` on that
frame (the same ops, batched), and within ``test_torch_gather.py``'s
limits (≤ 1 LSB on ≤ 1% of pixels) of the JAX ``VideoUpscaler``'s frame.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.models.video import VideoUpscaler as TpuVideo  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.models.video import _pipelined, _read_ahead, _stack_padded  # noqa: E402
from lanczos_torch.models._pipeline import Lane  # noqa: E402

SHAPE = (16, 12)


def _cfg(**kw):
    return lanczos_torch.ResampleConfig.from_profile("precise", SHAPE, scale=(2, 1), a=2, **kw)


def _frames(t, seed=42, shape=SHAPE):
    return np.random.default_rng(seed).integers(0, 256, (t,) + shape + (3,), dtype=np.uint8)


def _single(cfg, backend, frame):
    return lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")(
        torch.from_numpy(frame)).numpy()


def _close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


@pytest.mark.parametrize("backend", ["xla", "auto", "shift_xla"])
@pytest.mark.parametrize("batch,depth", [(3, 2), (1, 3), (4, 1), (8, 2)])
def test_video_matches_per_frame(backend, batch, depth):
    cfg = _cfg()
    video = _frames(7)
    vu = lanczos_torch.VideoUpscaler(cfg, backend=backend, depth=depth, batch=batch,
                                     device="cpu")
    out = vu(video)
    assert out.shape == (7, 32, 24, 3) and out.dtype == np.uint8
    for k in range(7):
        np.testing.assert_array_equal(out[k], _single(cfg, backend, video[k]))
    if backend == "xla":
        tcfg = lanczos_tpu.ResampleConfig.from_profile("precise", SHAPE, scale=(2, 1), a=2)
        _close(out, TpuVideo(tcfg, backend="xla", depth=depth, batch=batch)(video))


@pytest.mark.parametrize("batch", [1, 2, 5])
def test_video_frame_iterator_order(batch):
    cfg = _cfg()
    video = _frames(5)
    vu = lanczos_torch.VideoUpscaler(cfg, backend="xla", depth=3, batch=batch, device="cpu")
    outs = list(vu.frames(iter(video)))
    assert len(outs) == 5
    for k in range(5):
        np.testing.assert_array_equal(outs[k], _single(cfg, "xla", video[k]))
    assert list(vu.frames(iter(()))) == []


def test_video_kernel_path_on_the_cpu_runs_the_plain_version():
    cfg = _cfg(dering=True)
    video = _frames(4, seed=3)
    vu = lanczos_torch.VideoUpscaler(cfg, depth=2, batch=3, device="cpu")
    assert vu.model.path == "cuda" and vu.batch == 3 and vu.depth == 2
    outs = list(vu.frames(iter(video)))
    for k in range(4):
        np.testing.assert_array_equal(outs[k], _single(cfg, "auto", video[k]))


def test_video_wrong_dims():
    vu = lanczos_torch.VideoUpscaler(_cfg(), backend="xla", device="cpu")
    with pytest.raises(ValueError, match="frame dims"):
        list(vu.frames([np.zeros((8, 8, 3), np.uint8)]))
    with pytest.raises(ValueError, match="backend"):
        lanczos_torch.VideoUpscaler(_cfg(), backend="tpu", device="cpu")


def test_video_mesh_and_missing_cuda_raise():
    with pytest.raises(TypeError, match="Mesh"):  # mesh= takes a lanczos_torch Mesh
        lanczos_torch.VideoUpscaler(_cfg(), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        lanczos_torch.upscale_y4m("in.y4m", "out.y4m", scale=(2, 1), mesh=object(),
                                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lanczos_torch.VideoUpscaler(_cfg())  # device="cuda" by default


@pytest.mark.parametrize("batch", [1, 3])
def test_video_frames_producer_reuses_buffer(batch):
    """A producer that rewrites ONE preallocated frame buffer between
    pulls (camera/ffmpeg pattern) must not alias into the batch stack."""
    cfg = _cfg()
    frames = _frames(6)
    buf = np.empty_like(frames[0])

    def producer():
        for f in frames:
            buf[...] = f  # same ndarray object every iteration
            yield buf

    vu = lanczos_torch.VideoUpscaler(cfg, backend="xla", depth=2, batch=batch, device="cpu")
    outs = list(vu.frames(producer()))
    assert len(outs) == 6
    for k in range(6):
        np.testing.assert_array_equal(outs[k], _single(cfg, "xla", frames[k]))


def test_yielded_frames_own_their_memory():
    """Frames yielded earlier stay valid while later batches run."""
    cfg = _cfg()
    video = _frames(9, seed=7)
    vu = lanczos_torch.VideoUpscaler(cfg, backend="xla", depth=2, batch=2, device="cpu")
    gen = vu.frames(iter(video))
    first = next(gen)
    keep = first.copy()
    rest = list(gen)
    np.testing.assert_array_equal(first, keep)
    assert len(rest) == 8


def test_stack_padded_repeats_the_last_frame():
    lane = Lane("cpu")
    frames = list(_frames(2, seed=1))
    buf = _stack_padded(lane, frames, 4)
    assert tuple(buf.shape) == (4,) + SHAPE + (3,) and buf.dtype == torch.uint8
    got = buf.numpy()
    np.testing.assert_array_equal(got[:2], np.stack(frames))
    np.testing.assert_array_equal(got[2], frames[1])
    np.testing.assert_array_equal(got[3], frames[1])
    deep = _stack_padded(lane, [np.arange(6, dtype="<u2").reshape(1, 2, 3)], 2)
    assert deep.dtype == torch.uint16 and deep.shape == (2, 1, 2, 3)


def test_pipelined_keeps_depth_in_flight_and_drains_in_order():
    lane = Lane("cpu")
    seen, drained = [], []

    def launch(b):
        seen.append((b, len(lane)))
        lane.submit(b, [torch.full((2,), b)], lambda x: x + 1)

    _pipelined(lane, range(5), launch, lambda b, hosts: drained.append((b, int(hosts[0][0]))),
               depth=3)
    assert drained == [(b, b + 1) for b in range(5)]
    assert [n for _, n in seen] == [0, 1, 2, 2, 2] and len(lane) == 0


def test_read_ahead_order_errors_and_abandon():
    """_read_ahead: in-order delivery, producer exceptions re-raise at
    the consumer, and an abandoned consumer joins the producer thread."""
    assert list(_read_ahead(iter(range(50)), depth=3)) == list(range(50))

    def boom():
        yield 1
        raise RuntimeError("decoder died")

    out = []
    with pytest.raises(RuntimeError, match="decoder died"):
        for v in _read_ahead(boom()):
            out.append(v)
    assert out == [1]

    before = threading.active_count()
    g = _read_ahead(iter(range(10_000)), depth=2)
    assert next(g) == 0
    g.close()  # abandon: producer must stop and join
    assert threading.active_count() <= before


@pytest.mark.parametrize("backend,kw", [("auto", {}), ("gather", {}), ("auto", {"dering": True}),
                                        ("auto", {"precision": "bf16"})])
@pytest.mark.parametrize("batch", [1, 3])
def test_video_on_a_mesh_equals_no_mesh(backend, kw, batch):
    """mesh=: frames data-parallel, rows sharded; the batch rounds up to the
    data axis; every frame identical to the unsharded run's."""
    from lanczos_torch.parallel.mesh import Mesh

    cfg = _cfg(**kw)
    video = _frames(7, seed=5)
    mesh = Mesh.local(["cpu"] * 4, (2, 2))
    vu = lanczos_torch.VideoUpscaler(cfg, backend=backend, depth=2, batch=batch, mesh=mesh)
    assert vu.batch == 2 * (-(-batch // 2)) and vu.device == torch.device("cpu")
    assert vu.model.use_mxu == (backend == "auto")
    plain = lanczos_torch.VideoUpscaler(cfg, backend="xla" if backend == "gather" else "auto",
                                        depth=2, batch=batch, device="cpu")
    want = plain(video)
    np.testing.assert_array_equal(vu(video), want)
    outs = list(vu.frames(iter(video)))
    assert len(outs) == 7 and all(np.array_equal(o, w) for o, w in zip(outs, want))
