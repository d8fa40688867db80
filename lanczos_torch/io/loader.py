"""Threaded frame loading/saving pipeline: the port's copy of
``lanczos_tpu/io/loader.py``.

Word for word the original below this docstring, apart from
``lanczos_tpu.io`` read as ``lanczos_torch.io``.  A thread pool decodes
ahead (the native C++ unfilter releases the GIL through ctypes, so decodes
run in parallel) and a bounded prefetch queue overlaps host decode with
the card's work; :class:`FrameWriter` encodes and writes on background
threads with backpressure.  It takes and yields numpy arrays: read a
result off the card with ``.cpu().numpy()`` before writing it.
"""

from __future__ import annotations

import concurrent.futures as _fut
import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from lanczos_torch.io.png import write_png
from lanczos_torch.io import read_image


class FrameLoader:
    """Prefetching PNG reader over a list of paths.

    ``decode_workers`` threads decode ahead, at most ``prefetch`` frames
    buffered.  Iteration yields (path, (H, W, C) uint8) in order.
    """

    def __init__(
        self,
        paths: Sequence[str | os.PathLike],
        decode_workers: int = 4,
        prefetch: int = 8,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        self.paths = list(paths)
        self.workers = max(1, decode_workers)
        self.prefetch = max(1, prefetch)
        self.transform = transform

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[tuple[str, np.ndarray]]:
        def load(p):
            img = read_image(p)
            return self.transform(img) if self.transform else img

        with _fut.ThreadPoolExecutor(self.workers) as pool:
            pending: queue.Queue = queue.Queue()
            it = iter(self.paths)

            def submit_next():
                try:
                    p = next(it)
                except StopIteration:
                    return False
                pending.put((p, pool.submit(load, p)))
                return True

            for _ in range(self.prefetch):
                if not submit_next():
                    break
            while not pending.empty():
                path, fut = pending.get()
                img = fut.result()
                submit_next()
                yield str(path), img


class FrameWriter:
    """Asynchronous image writer: encode+write on background threads so
    the device loop never blocks on the host encoder.  Format follows the
    file extension (PNG plus the :func:`lanczos_torch.io.write_image`
    formats); ``compress_level`` applies to PNG."""

    def __init__(
        self,
        encode_workers: int = 4,
        compress_level: int = 6,
        max_pending: int = 8,
    ):
        self.pool = _fut.ThreadPoolExecutor(max(1, encode_workers))
        self.level = compress_level
        self._futs: list = []
        self._lock = threading.Lock()
        # backpressure: without a bound, a slow encoder buffers whole
        # frames (an 8K RGB frame is ~100 MB) until OOM, and errors only
        # surface at close()
        self._slots = threading.Semaphore(max(1, max_pending))

    def write(self, path, img: np.ndarray) -> None:
        img = np.asarray(img)
        self._slots.acquire()

        def task():
            try:
                if str(path).lower().endswith(".png"):
                    return write_png(path, img, self.level)
                from lanczos_torch.io import write_image

                return write_image(path, img)
            finally:
                self._slots.release()

        with self._lock:
            self._futs.append(self.pool.submit(task))

    def close(self) -> None:
        with self._lock:
            futs, self._futs = self._futs, []
        for f in futs:
            f.result()  # propagate errors
        self.pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
