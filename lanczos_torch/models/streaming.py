"""Row-streaming execution: unbounded image height under bounded device
memory (the port of ``lanczos_tpu/models/streaming.py``'s
``StreamingUpscaler``).

Output rows are produced in fixed-size chunks, each computed from just the
input-row window it needs (band start ``⌊y·D/N⌋−a+1`` … band end ``+a``),
so device memory is bounded by the chunk, not the frame.  The per-chunk
index rebasing is the analog of the reference's ``seek_write_index`` /
``curr_offset`` phase bookkeeping (``worker.cpp:199-202``) and makes
execution restartable at any output row (checkpoint / resume).

Device formulations, fastest first (``chunk_backend="auto"`` takes the
first whose gates pass; ``chunk_path`` names the one that runs):

1. ``"fused"`` (``chunk_backend="mxu"``): the fused CUDA kernel
   (``ops/resample_cuda.upscale_frames``) on one hand-built chunk plan.  With
   ``chunk ≡ 0 (mod N)`` every chunk shares one phase pattern, so an
   interior slice of a virtual tall operator serves all chunks, and the
   kernel's band-start formula picks it up through a constant offset
   shift; frame edges are reproduced by edge-mode padding the input window
   (hence drop-edge configs are excluded).  Within 1 LSB of the
   whole-frame result, not byte-equal: edge rows come from a padded window,
   not from folded weights.
2. ``"shift"``: strided shift-FMA tensor ops (``ops/resample_strided``) on
   a vertically padded window, integer-phase configs; byte-equal to the
   whole-frame gather path.
3. ``"gather"``: per-chunk rebased banded tables
   (``ops/resample_gather.apply_banded``), any float config; byte-equal to
   the whole-frame gather path.

On a CUDA device the chunks run through a ``_pipeline.Lane``: windows are
staged in page-locked host memory, uploaded and read back on copy streams
of their own, and ``depth`` chunks stay in flight.  On the CPU (the plain
versions) each chunk is computed when it is submitted.
"""

from __future__ import annotations

import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from lanczos_torch.core.config import EdgeMode, Order, Precision, ResampleConfig
from lanczos_torch.core.weights import banded_weights
from lanczos_torch.models._pipeline import (
    Lane,
    host_copy,
    host_empty,
    require_device,
    torch_dtype,
)
from lanczos_torch.models.upscaler import _shift_eligible
from lanczos_torch.ops.resample_cuda import (
    FusedOps,
    _round_bf16,
    build_fused_plan,
    make_fused_ops,
    plan_from_reference,
    upscale_frames,
)
from lanczos_torch.ops.resample_gather import (
    apply_banded,
    compute_dtype,
    quantize_uint8,
    store,
)
from lanczos_torch.ops.resample_strided import StridedOps, _axis_shift_pass
from lanczos_torch.parallel.mesh import Mesh

_NP_PAD = {"clamp": "edge", "reflect": "reflect"}  # fused windows: edge mode → np.pad
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}
CHUNK_BACKENDS = ("auto", "mxu", "shift", "gather")


def _join_prefetch(pool, fut) -> None:
    """Tear down a chunks() prefetch pool: an abandoned generator must not
    leave get_rows running on the worker thread after control returns to
    the caller — cancel what hasn't started, then join anything in flight.
    The join is bounded so a get_rows stalled on a dead source (socket,
    pipe) cannot hang generator close/GC forever."""
    if fut is not None and not fut.cancel():
        try:
            fut.result(timeout=60.0)
        except Exception:
            pass  # surfaced to nobody — the generator is dead
    pool.shutdown(wait=False, cancel_futures=True)


class StreamingUpscaler:
    """Chunked 2D resample: full-width horizontal pass, row-chunked vertical.

    ``chunk_rows`` is the number of OUTPUT rows per device step (rounded up
    to a multiple of the vertical phase count N so every chunk shares one
    weight layout).  ``dtype`` is the float paths' dtype (``cfg.precision``
    = bf16 overrides it, as everywhere in the port); ``device`` is where
    the chunks are computed, and ``"cuda"`` raises where CUDA is absent.
    """

    def __init__(
        self,
        cfg: ResampleConfig,
        chunk_rows: int = 512,
        dtype=torch.float32,
        chunk_backend: str = "auto",
        device="cuda",
    ):
        if cfg.precision == Precision.FIXED or cfg.c_faithful:
            raise NotImplementedError(
                "streaming supports the precise float paths only"
            )
        if chunk_backend not in CHUNK_BACKENDS:
            raise ValueError(f"unknown chunk_backend {chunk_backend!r}")
        self.cfg = cfg
        self.device = require_device(device)
        self.dtype = torch.bfloat16 if cfg.precision == Precision.BF16 else dtype
        self.compute = compute_dtype(self.dtype)
        self.pinned = True  # False: stage through pageable memory (for measuring)
        n, d = cfg.scale_h
        self.chunk = max(n, -(-min(chunk_rows, cfg.out_shape[0]) // n) * n)
        kw = dict(
            a=cfg.a, filter_name=cfg.filter, edge_mode=cfg.edge_mode,
            normalize=cfg.normalize, coord_mode="exact", align=cfg.align.value,
        )
        self.op_v = banded_weights(cfg.in_shape[0], cfg.out_shape[0], **kw)
        self.op_h = banded_weights(cfg.in_shape[1], cfg.out_shape[1], **kw)
        # uniform input-window size for every chunk (one shape a run)
        oh = cfg.out_shape[0]
        self.n_chunks = -(-oh // self.chunk)
        lo = np.minimum.reduce(self.op_v.idx, axis=1)
        hi = np.maximum.reduce(self.op_v.idx, axis=1)
        spans = []
        for k in range(self.n_chunks):
            y0, y1 = k * self.chunk, min((k + 1) * self.chunk, oh)
            spans.append((int(lo[y0:y1].min()), int(hi[y0:y1].max()) + 1))
        self.spans = spans
        self.win = max(b - a for a, b in spans)
        self.chunk_path = None
        # fused chunk path (the kernel): one interior-phase plan serves every
        # chunk; frame edges are reproduced by edge-mode padding the window
        if chunk_backend in ("auto", "mxu"):
            self._setup_fused()
        if chunk_backend == "mxu" and self.chunk_path != "fused":
            raise NotImplementedError(
                "fused chunk path needs chunk % N == 0, linear or height-first "
                "semantics, a non-DROP edge mode, a window no taller than the "
                "frame and a plan that fits shared memory"
            )
        if self.chunk_path == "fused":
            return
        # shift-FMA chunk path: needs the phase pattern chunk-invariant
        # and height-first linear semantics
        ih = cfg.in_shape[0]
        use_shift = chunk_backend in ("auto", "shift") and (
            _shift_eligible(cfg)
            and self.chunk % n == 0
            and cfg.order == Order.HEIGHT_FIRST
            and ih % d == 0
        )
        if chunk_backend == "shift" and not use_shift:
            raise NotImplementedError(
                "shift chunk path needs an integer upscale with "
                "height-first linear semantics"
            )
        if use_shift:
            self.shift = StridedOps(cfg, dtype, self.device)
            m = self.chunk // n
            self.win = m * d + 2 * self.shift.sup_v
            # unpadded input row origin of chunk k: k·m·d − sup_v
            self.w0_step = m * d
            self.chunk_path = "shift"
            return
        w_h, self._w_v = self.op_h.weights, self.op_v.weights
        if self.dtype == torch.bfloat16:  # as SeparableOps: each output's tap sum kept
            w_h, self._w_v = _round_bf16(w_h, 1), _round_bf16(self._w_v, 1)
        self._w_v = np.asarray(self._w_v, _NP_DTYPE[self.compute])
        self.idx_h = torch.from_numpy(self.op_h.idx.astype(np.int64)).to(self.device)
        self.w_h = torch.from_numpy(np.asarray(w_h)).to(self.device, self.compute)
        self.chunk_path = "gather"

    # ------------------------------------------------------------ fused path

    def _setup_fused(self) -> None:
        """Build the shared interior-chunk plan, or leave ``chunk_path``
        unset.

        With ``chunk ≡ 0 (mod N)``, ``y0·D/N`` is an integer for every
        chunk start, so ``fl(y0+y') − fl(y0)`` is one function of the
        chunk-local row y' — a middle slice of a virtual tall operator is
        the universal chunk operator, and the kernel's band-start formula
        picks it up through a constant offset shift
        ``off_eff = off + 2·D·(2·chunk) − 2·N·row0`` (the seek_write_index /
        curr_offset analog, worker.cpp:199-202)."""
        cfg = self.cfg
        n, d = cfg.scale_h
        if cfg.edge_mode == EdgeMode.DROP:
            return  # window padding cannot reproduce dropped-tap weights
        if (cfg.dering or cfg.intermediate_quantize) and cfg.order != Order.HEIGHT_FIRST:
            return  # nonlinearity makes the pass order observable
        chunk = self.chunk
        if chunk % n:
            return
        # virtual tall frame at the EXACT rational scale (banded_weights
        # derives N/D from its arguments); its middle slice is pure
        # interior pattern
        oh_v = 5 * chunk
        ih_v = oh_v * d // n  # exact: chunk ≡ 0 (mod n)
        op = banded_weights(
            ih_v, oh_v, cfg.a, cfg.filter, cfg.edge_mode, cfg.normalize,
            coord_mode="exact", align=cfg.align.value,
        )
        idx_s = op.idx[2 * chunk : 3 * chunk]
        w_s = op.weights[2 * chunk : 3 * chunk]
        if idx_s.min() <= 0 or idx_s.max() >= ih_v - 1:
            return  # slice touches the virtual edges (tiny chunk)
        row0 = int(idx_s.min())
        win = int(idx_s.max()) - row0 + 1
        if win > cfg.in_shape[0]:
            return  # frame shorter than one chunk window (np.pad limits)
        op_local = types.SimpleNamespace(
            idx=(idx_s - row0).astype(np.int32), weights=w_s, a=int(op.a)
        )
        off = 0 if cfg.align.value == "zero" else d - n
        off_eff = off + 2 * d * (2 * chunk) - 2 * n * row0
        syn = self._chunk_cfg(win)
        plan = None
        for tile, cb in ((64, 128), (32, 64), (16, 32)):  # fused_plan's ladder
            plan = build_fused_plan(syn, tile, op_local, self.op_h, n, d, off_eff, cb)
            if plan is not None:
                break
        if plan is None:
            return
        # global input row of chunk k's window-local row 0 (may be < 0 for
        # k = 0 / beyond ih for the tail — edge-mode padded); the slice
        # was taken at virtual chunk index 2
        step = chunk * d // n
        self._use_fused(make_fused_ops(syn, plan, self.device), win, row0 - 2 * step, step)

    def _chunk_cfg(self, win: int) -> ResampleConfig:
        """The synthetic config of one chunk: a ``win``-row window in, one
        chunk of rows out, at the frame's widths."""
        return dataclasses.replace(
            self.cfg,
            in_shape=(win, self.cfg.in_shape[1]),
            out_shape=(self.chunk, self.cfg.out_shape[1]),
        )

    def _use_fused(self, ops: FusedOps, win: int, row0_base: int, row0_step: int) -> None:
        self._mxu = ops
        self.mxu_row0_base, self.mxu_row0_step = row0_base, row0_step
        self.win = win
        self.chunk_path = "fused"

    @classmethod
    def from_reference(
        cls, cfg: ResampleConfig, chunk_rows: int, fields: dict, win: int,
        mxu_row0_base: int, mxu_row0_step: int, device="cuda",
    ) -> "StreamingUpscaler":
        """The fused chunk path on a JAX ``StreamingUpscaler``'s own chunk
        plan (``fields = vars(sm._mxu.mxu)``, with its ``win``,
        ``mxu_row0_base`` and ``mxu_row0_step``), so both packages run on
        exactly the same numbers."""
        self = cls(cfg, chunk_rows, chunk_backend="gather", device=device)
        ops = make_fused_ops(self._chunk_cfg(win), plan_from_reference(fields), self.device)
        self._use_fused(ops, win, mxu_row0_base, mxu_row0_step)
        return self

    # ------------------------------------------------------- device functions

    def _chunk_fn_fused(self, rows: torch.Tensor) -> torch.Tensor:
        """rows: (win, W, C) uint8 window, edge pads applied host-side."""
        return upscale_frames(rows[None], self._mxu)[0]

    def _chunk_fn_gather(self, rows, idx_v, w_v) -> torch.Tensor:
        """rows: (win, W, C) input window; idx_v rebased to the window."""
        cfg = self.cfg
        x = store(rows.to(self.compute), self.dtype)

        def between(v):
            v = quantize_uint8(v, v.dtype) if cfg.intermediate_quantize else v
            return store(v, self.dtype)

        if cfg.order == Order.WIDTH_FIRST:
            x = apply_banded(x, self.idx_h, self.w_h, 1, dering=cfg.dering)
            out = apply_banded(between(x), idx_v, w_v, 0, dering=cfg.dering)
        else:
            x = apply_banded(x, idx_v, w_v, 0, dering=cfg.dering)
            out = apply_banded(between(x), self.idx_h, self.w_h, 1, dering=cfg.dering)
        return quantize_uint8(out)

    def _chunk_fn_shift(self, rows: torch.Tensor) -> torch.Tensor:
        """rows: (win, W, C) window already carrying the vertical support
        pad (real neighbor rows interiorly, edge-mode rows at frame ends);
        the horizontal pad is the ops' column map."""
        cfg, sh = self.cfg, self.shift
        x = store(rows.movedim(-1, 0).to(sh.compute), sh.dtype)  # (C, win, W)
        w = x.shape[-1]
        xz = x.new_zeros(tuple(x.shape[:-1]) + (w + 1,))
        xz[..., :w] = x
        x = xz.index_select(-1, sh.cols)
        x = _axis_shift_pass(x, sh.nv, sh.dv, sh.sup_v, sh.tbl_v, 1, cfg.dering, sh.off_v)
        x = _axis_shift_pass(
            store(x, sh.dtype), sh.nh, sh.dh, sh.sup_h, sh.tbl_h, 2, cfg.dering, sh.off_h
        )
        return quantize_uint8(x).movedim(0, -1)

    def _chunk_fn(self, *args: torch.Tensor) -> torch.Tensor:
        """One chunk on the device: (chunk, OW, C) uint8."""
        if self.chunk_path == "fused":
            return self._chunk_fn_fused(*args)
        if self.chunk_path == "shift":
            return self._chunk_fn_shift(*args)
        return self._chunk_fn_gather(*args)

    # ------------------------------------------------------------- host side

    def _host_chunk_args(
        self, k: int, get_rows: Callable[[int, int], np.ndarray]
    ) -> Tuple[int, int, tuple, tuple]:
        """Host-side prep for chunk k: fetch the rows of its input window
        and slice/rebase the per-chunk tables.  Returns ``(y0,
        n_valid_rows, (rows, top, bottom, mode), tables)``: the window is
        ``rows`` with ``top`` and ``bottom`` rows of ``np.pad``'s ``mode``
        around it, built by :func:`_window`.  No device work and no large
        copy happens here, so it can run on a prefetch thread."""
        oh = self.cfg.out_shape[0]
        ih = self.cfg.in_shape[0]
        y0, y1 = k * self.chunk, min((k + 1) * self.chunk, oh)
        if self.chunk_path in ("fused", "shift"):
            if self.chunk_path == "fused":
                w0 = self.mxu_row0_base + k * self.mxu_row0_step
                mode = _NP_PAD[self.cfg.edge_mode.value]
            else:
                w0 = k * self.w0_step - self.shift.sup_v
                mode = self.shift.pad_mode  # np.pad's own names
            w1 = w0 + self.win  # unpadded origin may be < 0 / > ih
            lo2, hi2 = max(w0, 0), min(w1, ih)
            rows = np.asarray(get_rows(lo2, hi2))
            return y0, y1 - y0, (rows, lo2 - w0, w1 - hi2, mode), ()
        lo, hi = self.spans[k]
        hi_pad = lo + self.win  # uniform window: pad by repeating last row
        rows = np.asarray(get_rows(lo, min(hi_pad, ih)))
        # rebase global tap indices into the window; pad chunk rows to
        # self.chunk (tail chunk) with row 0 (output discarded)
        idx = (self.op_v.idx[y0:y1] - lo).astype(np.int64)
        w = self._w_v[y0:y1]
        if idx.shape[0] < self.chunk:
            padn = self.chunk - idx.shape[0]
            idx = np.concatenate([idx, np.zeros((padn, idx.shape[1]), idx.dtype)])
            w = np.concatenate([w, np.zeros((padn, w.shape[1]), w.dtype)])
        return y0, y1 - y0, (rows, 0, self.win - rows.shape[0], "edge"), (idx, w)

    def _submit(self, lane: Lane, args: tuple, dest=None) -> None:
        """Stage one chunk's host arguments (:meth:`_host_chunk_args`) on
        ``lane`` and submit this model's chunk function on them; the chunk's
        rows go to ``dest(y0, n)`` where given.  The staging copy stays on
        the lane's thread: the prefetch worker makes no CUDA call and starts
        no second team of copy threads."""
        y0, n, (rows, top, bot, mode), tables = args
        if lane.pinned:
            window = lane.host_empty(
                (top + rows.shape[0] + bot,) + rows.shape[1:], torch_dtype(rows.dtype))
            _window(window.numpy(), rows, top, bot, mode)
        else:
            window = torch.from_numpy(
                np.ascontiguousarray(_window(None, rows, top, bot, mode)))
        host = [window] + [torch.from_numpy(a) for a in tables]
        lane.submit(y0, host, lambda *a: self._chunk_fn(*a)[:n],
                    None if dest is None else [dest(y0, n)])

    def _run(self, get_rows, start_chunk, depth, prefetch, dest=None):
        """The generator behind :meth:`chunks`; ``dest(y0, n)`` names the
        host tensor a chunk's rows are read back into (default: a buffer
        of the chunk's own)."""
        depth = max(1, depth)
        ks = range(start_chunk, self.n_chunks)
        pool = ThreadPoolExecutor(max_workers=1) if prefetch and len(ks) > 1 else None
        lane = Lane(self.device, self.pinned)
        fut = None
        try:
            for j, k in enumerate(ks):
                y0, n, (rows, top, bot, mode), tables = (
                    self._host_chunk_args(k, get_rows) if fut is None else fut.result()
                )
                if pool is not None and j + 1 < len(ks):
                    fut = pool.submit(self._host_chunk_args, ks[j + 1], get_rows)
                else:
                    fut = None
                self._submit(lane, (y0, n, (rows, top, bot, mode), tables), dest)
                if len(lane) >= depth:
                    y0_, (out,) = lane.pop()
                    yield y0_, out
            while len(lane):
                y0_, (out,) = lane.pop()
                yield y0_, out
        finally:
            if pool is not None:
                _join_prefetch(pool, fut)
            lane.close()

    def chunks(
        self,
        get_rows: Callable[[int, int], np.ndarray],
        start_chunk: int = 0,
        depth: int = 3,
        prefetch: bool = True,
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (y0, chunk_output) pairs; resume via ``start_chunk``.

        ``get_rows(lo, hi)`` must return input rows [lo, hi) as
        (hi-lo, W, C) uint8 — from RAM, disk, or a decoder.

        Pipelined (the reference drains output concurrently with compute
        inside its DATAFLOW region, ``lanczos.cpp:53-65``): up to
        ``depth`` chunks stay in flight on the device — chunk k+1's upload
        runs on a copy stream while chunk k computes and chunk k−1 reads
        back on another, and the host only waits for a readback once the
        window is full.  With ``prefetch=True`` the NEXT chunk's
        ``get_rows`` host fetch additionally runs on a background thread
        while the device works; calls stay serialized and in ascending
        row order (safe for sequential decoders), but pass
        ``prefetch=False`` if the callback must run on the caller's
        thread.  Results are always yielded in order, byte-identical to
        the serial path; each yielded array owns its memory (page-locked
        on a CUDA device), so it stays valid while later chunks run.
        """
        return self._run(get_rows, start_chunk, depth, prefetch)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """Whole-frame convenience wrapper over :meth:`chunks`; on a CUDA
        device the chunks are read back straight into the returned array,
        which is page-locked."""
        img = np.asarray(img)
        oh, ow = self.cfg.out_shape
        pinned = self.pinned and self.device.type == "cuda"
        out = host_empty((oh, ow, img.shape[-1]), torch.uint8, pinned)
        for _ in self._run(
            lambda lo, hi: img[lo:hi], 0, 3, True, lambda y0, n: out[y0 : y0 + n]
        ):
            pass
        return out.numpy()



def _window(out: Optional[np.ndarray], rows: np.ndarray, top: int, bot: int,
            mode: str) -> np.ndarray:
    """``np.pad(rows, [(top, bot), (0, 0), ...], mode)`` written into the
    staging buffer ``out`` (a new array where none is given; ``rows``
    itself where there is nothing to pad or copy): the pad rows are
    gathered through ``np.pad`` of a row index, so each row is copied
    once."""
    if out is None:
        if not (top or bot):
            return rows
        out = np.empty((top + rows.shape[0] + bot,) + rows.shape[1:], rows.dtype)
    m = rows.shape[0]
    host_copy(out[top : top + m], rows)
    if top or bot:
        if mode == "constant":
            out[:top] = 0
            out[top + m :] = 0
        else:
            src = np.pad(np.arange(m), (top, bot), mode=mode)
            out[:top] = rows[src[:top]]
            out[top + m :] = rows[src[top + m :]]
    return out


class ShardedStreamingUpscaler(StreamingUpscaler):
    """Rows-sharded chunked execution (the port of the reference's
    ``ShardedStreamingUpscaler``): output rows in super-chunks of ``R ×
    chunk`` rows, one sub-chunk a position of the mesh's ``rows_axis``
    (``R`` positions; other axes replicate and run nothing), each position
    holding only its own sub-chunk's input window.

    Halo rows are duplicated when the host scatters the windows (the
    windows of neighbouring sub-chunks overlap by the vertical support), so
    no device exchange is needed: streamed input starts on the host, and the
    rows would cross the host link either way.  Every sub-chunk runs the
    single-device chunk program (:meth:`StreamingUpscaler._chunk_fn`, the
    fused kernel on the chunk plan where it applies) on the same window, so
    the result is byte-identical to :class:`StreamingUpscaler` at the same
    ``chunk_backend``.

    The mesh must be one process's (``Mesh.local``); on one card
    (``["cuda:0"] * R``) the sub-chunks run one after another.  Each
    distinct device has its own ``_pipeline.Lane``; a super-chunk's ``R``
    sub-chunks are submitted together and ``depth`` super-chunks stay in
    flight.  The tail super-chunk is padded with repeats of its last real
    sub-chunk (computed, not yielded), so every step runs ``R``
    sub-chunks; ``start_chunk`` must be a multiple of ``R``."""

    def __init__(
        self,
        cfg: ResampleConfig,
        mesh,
        rows_axis: str = "rows",
        chunk_rows: int = 512,
        dtype=torch.float32,
        chunk_backend: str = "auto",
    ):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh= takes a lanczos_torch.parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if not mesh.is_local:
            raise NotImplementedError(
                "the sharded stream's host feeds one process's devices: pass a "
                "Mesh.local (each rank may stream its own frames)")
        self.mesh, self.rows_axis = mesh, rows_axis
        k = mesh.axis(rows_axis)
        self.R = mesh.shape[rows_axis]
        origin = [0] * len(mesh.axis_names)
        self._ring = []  # the device of each sub-chunk of a super-chunk
        for r in range(self.R):
            origin[k] = r
            self._ring.append(mesh.device(tuple(origin)))
        super().__init__(cfg, chunk_rows=chunk_rows, dtype=dtype,
                         chunk_backend=chunk_backend, device=self._ring[0])
        self.n_groups = -(-self.n_chunks // self.R)
        self._models = {self.device: self}
        for dev in self._ring:  # the same chunk program's tables on each device
            if dev not in self._models:
                self._models[dev] = StreamingUpscaler(
                    cfg, chunk_rows=chunk_rows, dtype=dtype, chunk_backend=chunk_backend,
                    device=dev)

    def _host_group_args(self, g: int, get_rows) -> list:
        """Host prep for super-chunk g: the R sub-chunks' argument sets.
        Tail groups pad with the last real sub-chunk's arguments (n = 0
        rows kept); ``get_rows`` calls stay ascending and serialized."""
        group, prev = [], None
        for r in range(self.R):
            k = g * self.R + r
            if k < self.n_chunks:
                prev = self._host_chunk_args(k, get_rows)
                group.append(prev)
            else:
                y0, _, window, tables = prev
                group.append((y0, 0, window, tables))
        return group

    def _run(self, get_rows, start_chunk, depth, prefetch, dest=None):
        if start_chunk % self.R:
            raise ValueError(
                f"start_chunk must be a multiple of the rows-axis size "
                f"{self.R} (one device step = {self.R} sub-chunks)"
            )
        depth = max(1, depth)
        gs = range(start_chunk // self.R, self.n_groups)
        pool = ThreadPoolExecutor(max_workers=1) if prefetch and len(gs) > 1 else None
        lanes = {dev: Lane(dev, self.pinned) for dev in self._models}
        fut, inflight = None, 0
        try:
            for j, g in enumerate(gs):
                group = self._host_group_args(g, get_rows) if fut is None else fut.result()
                if pool is not None and j + 1 < len(gs):
                    fut = pool.submit(self._host_group_args, gs[j + 1], get_rows)
                else:
                    fut = None
                for dev, args in zip(self._ring, group):
                    self._models[dev]._submit(lanes[dev], args, dest)
                inflight += 1
                if inflight >= depth:
                    yield from self._drain(lanes)
                    inflight -= 1
            for _ in range(inflight):
                yield from self._drain(lanes)
        finally:
            if pool is not None:
                _join_prefetch(pool, fut)
            for lane in lanes.values():
                lane.close()

    def _drain(self, lanes: dict):
        """The oldest super-chunk's sub-chunks, in order (padding dropped)."""
        for dev in self._ring:
            y0, (out,) = lanes[dev].pop()
            if out.shape[0]:
                yield y0, out

    def chunks(self, get_rows, start_chunk: int = 0, depth: int = 2, prefetch: bool = True):
        """Yield (y0, chunk_output) pairs, R sub-chunks per device step.

        Same contract as the base class; ``start_chunk`` (for resume) must
        align to a super-chunk boundary (a multiple of the rows-axis size
        R: each device step produces R sub-chunks at once)."""
        return self._run(get_rows, start_chunk, depth, prefetch)
