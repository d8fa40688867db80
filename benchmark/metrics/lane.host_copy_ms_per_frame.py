"""Host milliseconds a frame inside the program span
``lanczos_torch.lane.host_copy``: copying each pageable frame into its
page-locked staging buffer (one card).

Read in the traced window; the copy is one aten op, so the profiler adds
little to it, but the copy's rate depends on the host's memory traffic
(the card's DMA in both directions included).  It moves with a faster or
avoided staging copy."""

from benchmark import spans


def read(m):
    return spans.ms_per_frame(m, spans.LANE_HOST_COPY)
