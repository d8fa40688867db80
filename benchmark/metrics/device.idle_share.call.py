"""The share of the traced window, in percent, in which the cell's card runs
neither a kernel nor a copy (calls on inputs already on the card)."""

from benchmark import readers


def read(m):
    return readers.idle_share(m, "first")
