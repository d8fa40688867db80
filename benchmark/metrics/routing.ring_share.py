"""The share of the fused kernel's device time, in percent, that the traced
window spent in launches of the pipelined ring kernel
(``fused_resample_kernel_ring``): what ``ops/resample_cuda.ring_shape``
routed to the ring rather than to the one-tile kernel.  100 where every
launch took the ring; it falls where a change to a plan's geometry sends
launches to the one-tile kernel.  ``None`` where no fused kernel ran."""

from benchmark import readers

RING = readers.FUSED + "_ring"


def read(m):
    if m.trace is None:
        return None
    fused = sum(o.end - o.start for o in m.trace.ops_of("kernel", readers.FUSED))
    if not fused:
        return None
    ring = sum(o.end - o.start for o in m.trace.ops_of("kernel", RING))
    return 100.0 * ring / fused
