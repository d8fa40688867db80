"""Host milliseconds a frame inside the program span
``lanczos_torch.lane.wait``: the host blocked on a batch's readback, its
slack behind the card (one card).

A traced-window number, and a balance rather than a cost: while the
host's staging and submit take longer than the card's period a frame, the
readback is done before the host asks and this reads near 0, as it does
in this cell with the profiler on and off.  It rises when the host's work
a frame falls under the card's period, and then falls with a faster
readback; while the host sets the rate, a faster readback cannot lower
it."""

from benchmark import spans


def read(m):
    return spans.ms_per_frame(m, spans.LANE_WAIT)
