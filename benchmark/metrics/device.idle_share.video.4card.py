"""The share of the traced window, in percent, in which a card runs neither
a kernel nor a copy, averaged over the four cards (frames from host
memory, a frame a card)."""

from benchmark import readers


def read(m):
    return readers.idle_share(m, "mean")
