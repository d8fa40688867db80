"""The share of the traced window, in percent, in which the card runs
neither a kernel nor a copy (frames from host memory, one card)."""

from benchmark import readers


def read(m):
    return readers.idle_share(m, "mean")
