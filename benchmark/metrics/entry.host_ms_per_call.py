"""The host's own milliseconds a call of the public entry, the mean over the
traced window's calls: the outermost program span of the entry
(``lanczos_torch.upscale``, ``lanczos_torch.upscaler.call`` or
``lanczos_torch.upscaler.planar``: the config, the cache lookup, the
layout copies' and the kernel's launches) less the time the host spent
inside it blocked on a full launch queue (``Command Buffer Full``), which
in a device-bound loop fills the rest of the card's time a call.

A traced-window number: it includes the profiler's cost of each of the
call's aten ops and launches, so it is above the call's untraced host cost.
It moves when a call does fewer or cheaper host operations (fewer ops, a
cached plan, fused layout copies)."""

from benchmark import spans


def read(m):
    return spans.own_mean_ms(m, spans.ENTRY)
