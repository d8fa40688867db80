"""Of the card's idle time in the traced window, the share in percent during
which the driving thread was inside the program span
``lanczos_torch.lane.host_copy`` (one card, frames from host memory).

The balance of the traced window, where the profiler slows the host: it
names the stage the card waits on there.  It moves with a faster or
overlapped staging copy."""

from benchmark import spans


def read(m):
    return spans.idle_share_in(m, spans.LANE_HOST_COPY)
