"""Spans at the port's layer boundaries, seen by ``torch.profiler``.

:func:`span` returns ``torch.profiler.record_function(name)`` while a
profiler session is recording, and otherwise one shared no-op context,
decided by ``torch.autograd.profiler._is_profiler_enabled`` (a module
global the profiler sets on start and clears on stop).  With the profiler
off a span site builds nothing: an attribute read and a ``with`` on a
``nullcontext``.  Entering and leaving a ``record_function`` costs more
than the span it would record, so no site pays for it untraced.

A span is a CPU user annotation of the profiler's trace: on the same clock
as the CUDA operations it records, nested on the calling thread under the
span that encloses it, held in memory by the profiler and written out only
by whoever exports the trace (:func:`lanczos_torch.utils.profiling.trace`
writes a Chrome trace).  There is no switch of its own: trace to see them.

The spans, by layer:

- the public entry: :data:`UPSCALE` (``upscale``: the config, the cache
  lookup, the call), :data:`UPSCALER_CALL` (``Upscaler.__call__``) and
  :data:`UPSCALER_PLANAR` (``Upscaler.planar``); a call's outermost one
  covers it;
- a :class:`~lanczos_torch.models._pipeline.Lane`: :data:`LANE_HOST_COPY`
  (a frame's copy into a staging buffer), :data:`LANE_SUBMIT` (the upload
  enqueue, the device function, the readback enqueue) and
  :data:`LANE_WAIT` (the host blocked on an item's readback; empty on a
  CPU lane);
- the sharding: :data:`SHARDED_CALL` (``ShardedUpscaler.__call__``:
  scatter, per-card work, gather to the first card);
- the routing: :data:`FUSED_RING` and :data:`FUSED_TILE`, one around each
  launch of the fused kernel on a card, planar or interleaved (the one
  launch function, ``ops/resample_cuda._launch``, which ``fused_call`` and
  ``upscale_frames`` both call), named by the kernel it takes: the pipelined
  ring where the layout's route (``ring_shape``, asked once when its tables
  were uploaded) has one and the input and output are aligned, else the
  one-tile kernel.  A CPU call runs the plain version and records neither.

Spans of one item share no identifier: a lane pops in submit order, so the
n-th :data:`LANE_SUBMIT` and the n-th :data:`LANE_WAIT` of a trace belong
to the same item.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

UPSCALE = "lanczos_torch.upscale"
UPSCALER_CALL = "lanczos_torch.upscaler.call"
UPSCALER_PLANAR = "lanczos_torch.upscaler.planar"
LANE_HOST_COPY = "lanczos_torch.lane.host_copy"
LANE_SUBMIT = "lanczos_torch.lane.submit"
LANE_WAIT = "lanczos_torch.lane.wait"
SHARDED_CALL = "lanczos_torch.sharded.call"
FUSED_RING = "lanczos_torch.fused.ring"
FUSED_TILE = "lanczos_torch.fused.tile"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while the profiler records, else
    the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
