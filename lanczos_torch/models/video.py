"""Video / frame-sequence upscaling pipeline (the port of
``lanczos_tpu/models/video.py``).

Drives the fused kernel (or any :class:`Upscaler` backend) over a frame
stream with host↔device transfer overlap: frame batches are staged in
page-locked host memory, batch k+1's upload runs on a copy stream while
batch k computes and batch k−1 reads back on another, and results are
fetched with a sliding in-flight window so the device never idles waiting
for the host (the frame-level analog of the reference's DATAFLOW stage
overlap, ``lanczos.cpp:72-82``).  The window is a ``_pipeline.Lane``, as
in :mod:`lanczos_torch.models.streaming`.

For frame batches that fit device memory, prefer stacking frames into the
batch dim of :class:`lanczos_torch.models.upscaler.Upscaler` directly (one
kernel launch); this module is for long/unbounded sequences.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator

import numpy as np
import torch

from lanczos_torch.core.config import ResampleConfig
from lanczos_torch.models._pipeline import Lane, host_copy, require_device, torch_dtype
from lanczos_torch.models.upscaler import Upscaler
from lanczos_torch.parallel.mesh import Mesh


def _sharded(cfg: ResampleConfig, mesh, data_axis: str, rows_axis: str, backend: str):
    """A ``ShardedUpscaler`` over ``mesh`` and the device its results land
    on (this process's first position's)."""
    from lanczos_torch.parallel.sharded import ShardedUpscaler

    model = ShardedUpscaler(cfg, mesh, data_axis=data_axis, rows_axis=rows_axis,
                            backend=backend)
    return model, mesh.device(mesh.local_positions()[0])


def _round_to_data(batch: int, mesh, data_axis: str) -> int:
    """``batch`` rounded up to a multiple of the data-axis size (every
    launch keeps one shape)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a lanczos_torch.parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    d_n = mesh.shape[data_axis]
    return -(-max(1, batch) // d_n) * d_n


def _stack_padded(lane: Lane, frames, b: int) -> torch.Tensor:
    """The frames (arrays of one shape) stacked into a new (b, ...) staging
    buffer of ``lane``, the tail filled by repeating the last frame (the
    reference's ``_pad_to``): every launch keeps one shape, one kernel
    grid and one size of staging buffer; callers discard the padded rows
    on drain."""
    first = np.asarray(frames[0])
    buf = lane.host_empty((b,) + first.shape, torch_dtype(first.dtype))
    view = buf.numpy()
    for i, frame in enumerate(frames):
        host_copy(view[i], np.asarray(frame))
    view[len(frames):] = view[len(frames) - 1]
    return buf


def _read_ahead(gen, depth: int = 2):
    """Iterate ``gen`` on a background thread, keeping up to ``depth``
    items queued, so the producer's file parse/copy work hides under the
    consumer's device time (the host-I/O analog of
    ``StreamingUpscaler``'s threaded ``get_rows`` prefetch).  Items
    arrive in order; producer exceptions re-raise at the consumer; an
    abandoned consumer stops the producer at the next item and joins,
    giving up after 60 s on a producer stalled inside one item."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()
    err: list = []

    def run():
        try:
            for item in gen:
                if stop.is_set():
                    return
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            # the sentinel MUST arrive (a full queue would otherwise
            # leave the consumer blocked on get); bounded retries so an
            # abandoned consumer (stop set, queue full) still lets us exit
            while not stop.is_set():
                try:
                    q.put(done, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        deadline = time.monotonic() + 60.0
        while t.is_alive() and time.monotonic() < deadline:
            try:  # unblock a full-queue put, then join
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)


def _pipelined(lane: Lane, batches, launch, drain, depth: int) -> None:
    """Run launch() over batches keeping ``depth`` results in flight.

    ``launch(b)`` submits a batch to ``lane`` and returns at once; drain()
    gets an item's ``(meta, results)`` once its readback has finished, and
    only runs once the window is full — the frame-level analog of the
    reference's DATAFLOW stage overlap (``lanczos.cpp:72-82``)."""
    try:
        for b in batches:
            launch(b)
            if len(lane) >= depth:
                drain(*lane.pop())
        while len(lane):
            drain(*lane.pop())
    finally:
        lane.close()


class VideoUpscaler:
    """Stream frames through an :class:`Upscaler` with a bounded in-flight
    queue.

    ``depth`` batches are kept in flight on the device: deep enough to hide
    host transfer latency, shallow enough to bound device memory.
    ``device`` is where the frames are computed (``"cuda"`` raises where
    CUDA is absent).

    With ``mesh`` given (a :class:`~lanczos_torch.parallel.mesh.Mesh`), the
    per-batch model is a
    :class:`~lanczos_torch.parallel.sharded.ShardedUpscaler` over its
    (data × rows) axes: frames data-parallel across the ``data`` axis, each
    frame's rows split with a ring halo exchange.  ``batch`` is rounded up
    to a multiple of the data-axis size, batches are staged for the device
    of this process's first position (``device`` is then unused), and the
    results are the unsharded model's bytes.
    """

    def __init__(
        self,
        cfg: ResampleConfig,
        backend: str = "auto",
        depth: int = 3,
        batch: int = 1,
        mesh=None,
        data_axis: str = "data",
        rows_axis: str = "rows",
        device="cuda",
    ):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            self.batch = _round_to_data(batch, mesh, data_axis)
            self.model, self.device = _sharded(cfg, mesh, data_axis, rows_axis, backend)
        else:
            self.device = require_device(device)
            self.model = Upscaler(cfg, backend=backend, device=self.device)
            self.batch = max(1, batch)
        self.depth = max(1, depth)

    def _submit(self, lane: Lane, stack: torch.Tensor, n: int, dests=None) -> None:
        """One (batch, H, W, C) staging buffer, its first ``n`` frames real."""
        lane.submit(n, [stack], lambda x: self.model(x)[:n], dests)

    def frames(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Yield upscaled frames in order; input (H, W, C) uint8 each.

        Frames are launched in ``batch``-size stacks (the tail stack is
        pad-repeated to keep one shape) with ``depth`` stacks in flight.
        Each frame is copied into its stack's staging buffer as it is
        pulled, so the producer may legally reuse its frame buffer
        (camera/ffmpeg pattern) between our pulls."""
        lane = Lane(self.device)
        try:
            stack, n = None, 0
            for frame in frames:
                if frame.shape[:2] != tuple(self.cfg.in_shape):
                    raise ValueError(
                        f"frame dims {frame.shape[:2]} != config "
                        f"{self.cfg.in_shape}"
                    )
                frame = np.asarray(frame)
                if stack is None:
                    stack = lane.host_empty(
                        (self.batch,) + frame.shape, torch_dtype(frame.dtype))
                host_copy(stack.numpy()[n], frame)
                n += 1
                if n == self.batch:
                    self._submit(lane, stack, n)
                    stack, n = None, 0
                    if len(lane) >= self.depth:
                        yield from lane.pop()[1][0]
            if n:
                stack.numpy()[n:] = stack.numpy()[n - 1]
                self._submit(lane, stack, n)
            while len(lane):
                yield from lane.pop()[1][0]
        finally:
            lane.close()

    def __call__(self, video: np.ndarray) -> np.ndarray:
        """(T, H, W, C) uint8 → (T, OH, OW, C) uint8, batched in chunks; on
        a CUDA device the batches are read back straight into the returned
        array, which is page-locked."""
        video = np.asarray(video)
        t = video.shape[0]
        oh, ow = self.cfg.out_shape
        lane = Lane(self.device)
        out = lane.host_empty((t, oh, ow, video.shape[-1]), torch.uint8)
        b = self.batch

        def launch(k0):
            part = video[k0 : k0 + b]
            self._submit(lane, _stack_padded(lane, part, b), len(part), [out[k0 : k0 + b]])

        _pipelined(lane, range(0, t, b), launch, lambda n, hosts: None, self.depth)
        return out.numpy()


def upscale_y4m(
    src,
    dst,
    scale=None,
    out_shape=None,
    profile="precise",
    a: int = 3,
    backend: str = "auto",
    batch: int = 8,
    depth: int = 3,
    mesh=None,
    data_axis: str = "data",
    rows_axis: str = "rows",
    device="cuda",
    **overrides,
):
    """Upscale a .y4m video file plane-natively: file → file.

    Y4M frames are already planar YCbCr — the layout the fused kernels
    prefer — so each plane batch goes straight through ``Upscaler.planar``
    with no color conversion and no interleave transposes.  Luma and
    chroma get their own configs at the same rational scale (chroma planes
    are subsampled, so their dims differ); the output keeps the input's
    chroma subsampling and frame rate.

    ``batch`` frames share one device dispatch per plane (sub-ms kernels
    are dispatch-bound otherwise); ``depth`` plane-batches stay in flight
    to overlap host I/O with device compute (the frame-level analog of the
    reference's DATAFLOW overlap, ``lanczos.cpp:72-82``).  ``device`` is
    where the planes are computed.

    With ``mesh`` given, each plane batch runs through a
    :class:`~lanczos_torch.parallel.sharded.ShardedUpscaler` over the
    (data × rows) mesh: ``batch`` is rounded up to a multiple of the
    data-axis size, and every plane's in/out heights must divide the
    rows-axis size (chroma planes included).  Byte-identical to the
    unsharded run of the same profile.

    Returns the output :class:`lanczos_torch.io.y4m.Y4MHeader`.
    """
    from lanczos_torch.io.y4m import Y4MError, Y4MHeader, Y4MReader, Y4MWriter

    if mesh is not None:
        batch = _round_to_data(batch, mesh, data_axis)
    else:
        device = require_device(device)
    with Y4MReader(src) as reader:
        hdr = reader.header
        shapes = [(hdr.height, hdr.width)]
        if hdr.chroma_shape is not None:
            shapes.append(hdr.chroma_shape)

        models = []
        for hw in shapes:
            cfg = ResampleConfig.from_profile(
                profile, hw, out_shape=None if out_shape is None else (
                    out_shape[0] * hw[0] // hdr.height,
                    out_shape[1] * hw[1] // hdr.width,
                ),
                scale=scale, a=a, **overrides,
            )
            if mesh is not None:
                model, device = _sharded(cfg, mesh, data_axis, rows_axis, backend)
                models.append(model)
            else:
                models.append(Upscaler(cfg, backend=backend, device=device))
        oh, ow = models[0].cfg.out_shape
        if hdr.chroma_shape is not None:
            coh, cow = models[1].cfg.out_shape
            div = (hdr.height // hdr.chroma_shape[0],
                   hdr.width // hdr.chroma_shape[1])
            if (coh * div[0], cow * div[1]) != (oh, ow):
                raise Y4MError(
                    f"output {ow}x{oh} cannot keep C{hdr.colorspace} "
                    f"subsampling (chroma maps to {cow}x{coh})"
                )

        out_hdr = Y4MHeader(
            ow, oh, fps=hdr.fps, interlace=hdr.interlace,
            aspect=hdr.aspect, colorspace=hdr.colorspace,
            extensions=hdr.extensions,
        )

        def plane_batches():
            """Yield lists of ``batch`` frames (plane tuples)."""
            buf = []
            for frame in reader:
                buf.append(frame)
                if len(buf) == batch:
                    yield buf
                    buf = []
            if buf:
                yield buf

        lane = Lane(device)

        def launch(frames):
            # luma (B,1,h,w); Cb+Cr share one (B,2,ch,cw) dispatch — the
            # planes have the same model/shape, and sub-ms kernels are
            # dispatch-bound, so merging saves one launch per batch
            staged = [_stack_padded(lane, [f[0][None] for f in frames], batch)]
            if len(models) > 1:
                staged.append(_stack_padded(lane, [np.stack(f[1:]) for f in frames], batch))
            lane.submit(len(frames), staged, run_planes)

        def run_planes(*planes):
            if mesh is None:
                return [m.planar(x) for m, x in zip(models, planes)]
            # the sharded path takes (B, h, w, P) frames
            return [m(x.movedim(1, -1)).movedim(-1, 1) for m, x in zip(models, planes)]

        with Y4MWriter(dst, out_hdr) as writer:

            def drain(n, host):
                if hdr.bit_depth > 8:
                    # deep streams: the uint16 dtype contract clips at
                    # 65535, but the stream's legal range is 2^depth−1 —
                    # clamp the Lanczos overshoot to it (the 8-bit path's
                    # clamp_to_byte at stream width); trunc only floats
                    # (device output is already uint16)
                    lim = (1 << hdr.bit_depth) - 1
                    host = [
                        np.clip(
                            h if h.dtype == np.uint16 else np.trunc(h),
                            0, lim,
                        ).astype(np.uint16)
                        for h in host
                    ]
                else:
                    # the ref backend returns unquantized floats; match the
                    # device paths' trunc-clip byte cast before writing
                    host = [
                        h if h.dtype == np.uint8
                        else np.trunc(np.clip(h, 0, 255)).astype(np.uint8)
                        for h in host
                    ]
                for k in range(n):
                    planes = (host[0][k, 0],)
                    if len(host) > 1:
                        planes += (host[1][k, 0], host[1][k, 1])
                    writer.write(planes)

            # frame parse/copy on a read-ahead thread: container I/O
            # hides under device compute (bounded queue, in order).
            # closing() joins the producer DETERMINISTICALLY on any
            # launch/drain exception — before the with-blocks close the
            # reader the thread is still parsing from
            from contextlib import closing

            with closing(_read_ahead(plane_batches())) as batches:
                _pipelined(lane, batches, launch, drain, depth)
    return out_hdr
