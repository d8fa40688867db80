"""The in-flight window of the streaming and video paths: host staging,
copy streams and events around one device function.

The JAX package has no counterpart: there ``jnp.asarray`` and
``np.asarray`` are the whole transfer code, and XLA's async dispatch
overlaps them with the compute.  In PyTorch a copy from pageable memory
blocks the host and ``.cpu()`` waits for the device, so a literal port
would run upload, kernel and readback one after another.  A :class:`Lane`
keeps them apart on a CUDA device:

- host buffers come page-locked from PyTorch's caching host allocator
  (:meth:`Lane.host_empty`), so both copy directions are asynchronous;
- uploads run on one side stream and readbacks on another (the link is
  full duplex), the device function on the caller's current stream, with
  an event between upload → function → readback;
- an item's host inputs, device inputs and device results stay referenced
  by the lane until its readback event has been waited for, so no
  allocator (host or device) hands a block to a later item while a stream
  still reads or writes it, whichever stream the block was allocated on;
- every result lands in a host buffer of its own (or in the destination
  the caller names), so an array handed out earlier is never written
  again;
- every CUDA call, and every copy into a staging buffer, is made by the
  thread that drives the lane: a prefetch thread only fetches;
- the two copy streams are made once a device and shared by every lane:
  PyTorch's device allocator keeps a pool a stream, so a lane with
  streams of its own would ``cudaMalloc`` its first uploads anew (2–4 ms a
  run on an H100) and strand the blocks of the lane before it;
- host copies into staging buffers go through :func:`host_copy`
  (``Tensor.copy_``, which splits a large copy over PyTorch's intra-op
  threads): 50–59 GB/s on the H100's 8-core host where a numpy assignment
  reaches 7–10.  Each thread that calls it gets a team of copy threads of
  its own, which costs 3 ms to start: another reason to keep these copies
  on one thread.

On the CPU a lane has no streams and no page-locked memory and calls no
``torch.cuda`` function: ``submit`` runs the function at once.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from lanczos_torch.utils.tracing import LANE_HOST_COPY, LANE_SUBMIT, LANE_WAIT, span


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it names CUDA and
    CUDA is absent (the port never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch version"
        )
    return device


def host_empty(shape, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """An uninitialized host tensor, page-locked if ``pinned`` (from
    PyTorch's caching host allocator: a CUDA call on a cache miss)."""
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=pinned)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def host_copy(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` for host arrays, on PyTorch's intra-op threads."""
    with span(LANE_HOST_COPY):
        src = np.ascontiguousarray(src)
        if not src.flags.writeable:  # torch.from_numpy warns on a read-only array
            dst[...] = src
            return
        torch.from_numpy(dst).copy_(torch.from_numpy(src))


@functools.lru_cache(maxsize=None)
def _copy_streams(device: torch.device) -> tuple:
    """``(upload, readback)`` streams of ``device``, made once a process."""
    return torch.cuda.Stream(device), torch.cuda.Stream(device)


class Lane:
    """Up to any number of submitted items in flight on ``device``, popped
    in order.  ``pinned=False`` stages through pageable memory instead
    (what a literal port would do: for measuring what pinning is worth)."""

    def __init__(self, device, pinned: bool = True):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pinned = pinned and self.cuda
        if self.cuda:
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.up, self.down = _copy_streams(self.device)
        self._items: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._items)

    def host_empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialized host tensor to stage through: page-locked on a
        CUDA lane.  Call it on the lane's thread."""
        return host_empty(shape, dtype, self.pinned)

    def submit(
        self,
        meta,
        inputs: Sequence[torch.Tensor],
        fn: Callable[..., object],
        dests: Optional[Sequence[torch.Tensor]] = None,
    ) -> None:
        """Upload the host tensors ``inputs``, run ``fn(*on_device)`` (one
        tensor or a sequence of tensors) and read every result back, into
        ``dests`` (host tensors of the results' shapes) or into new host
        buffers; returns once all of it is enqueued."""
        with span(LANE_SUBMIT):
            if not self.cuda:
                results = _as_list(fn(*inputs))
                self._items.append((meta, _deliver(results, dests), None, None))
                return
            here = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.up):
                on_device = [t.to(self.device, non_blocking=True) for t in inputs]
                uploaded = self.up.record_event()
            here.wait_event(uploaded)
            results = [r.contiguous() for r in _as_list(fn(*on_device))]
            computed = here.record_event()
            if dests is None:
                dests = [self.host_empty(r.shape, r.dtype) for r in results]
            with torch.cuda.stream(self.down):
                self.down.wait_event(computed)
                for dst, r in zip(dests, results):
                    dst.copy_(r, non_blocking=True)
                done = self.down.record_event()
            # the references keep every block out of its allocator until `done`
            self._items.append((meta, list(dests), done, (inputs, on_device, results)))

    def pop(self) -> tuple:
        """``(meta, [result as a numpy array, ...])`` of the oldest item,
        once its readback has finished."""
        meta, hosts, done, _keep = self._items.popleft()
        with span(LANE_WAIT):
            if done is not None:
                done.synchronize()
        return meta, [h.numpy() for h in hosts]

    def close(self) -> None:
        """Wait for everything still in flight and drop it (an abandoned
        run must not free blocks a stream still uses); a CUDA error raised
        by the wait propagates."""
        while self._items:
            _, _, done, _keep = self._items.popleft()
            if done is not None:
                done.synchronize()


def _as_list(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _deliver(results: list, dests) -> list:
    """CPU lane: the results themselves, or copied into ``dests``."""
    if dests is None:
        return [r.contiguous() for r in results]
    for dst, r in zip(dests, results):
        dst.copy_(r)
    return list(dests)
