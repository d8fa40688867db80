"""Host milliseconds a frame inside the program span
``lanczos_torch.lane.wait``: the host blocked on a batch's readback from
the first card (four cards).

A traced-window number and a balance, as ``lane.wait_ms_per_frame``: it
reads the host's slack behind the first card's readback as the profiler
leaves it, and moves when the host's work a batch or the readback
changes."""

from benchmark import spans


def read(m):
    return spans.ms_per_frame(m, spans.LANE_WAIT)
