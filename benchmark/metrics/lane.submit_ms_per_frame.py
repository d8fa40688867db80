"""Host milliseconds a frame inside the program span
``lanczos_torch.lane.submit``: enqueueing a batch's upload, the device
function and the readback (one card).

A traced-window number: the span encloses tens of aten ops, each of which
costs the profiler microseconds, so it is above the untraced cost.  It
moves when the submit does fewer host operations."""

from benchmark import spans


def read(m):
    return spans.ms_per_frame(m, spans.LANE_SUBMIT)
