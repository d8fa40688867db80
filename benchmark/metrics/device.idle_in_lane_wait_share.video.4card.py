"""Of each card's idle time in the traced window, the share in percent
during which the driving thread was inside the program span
``lanczos_torch.lane.wait``, averaged over the four cards.

The balance of the traced window, where the profiler slows the host: a
high share says the cards wait on the first card's readback, a low one
that they wait on the host's own work."""

from benchmark import spans


def read(m):
    return spans.idle_share_in(m, spans.LANE_WAIT)
