"""Host milliseconds a frame inside the program span
``lanczos_torch.sharded.call``: enqueueing the scatter, the per-card
kernels and ``cat``s and the gather to the first card (four cards).

A traced-window number: it includes the profiler's cost of each aten op
and launch inside, so it is above the untraced cost.  It moves when the
sharded call does fewer host operations (fewer ``cat``s and copies)."""

from benchmark import spans


def read(m):
    return spans.ms_per_frame(m, spans.SHARDED_CALL)
