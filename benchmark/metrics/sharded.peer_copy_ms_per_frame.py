"""Device milliseconds a frame of the traced window's copies from one card
to another (``Memcpy PtoP``: the scatter of a batch's frames to their
cards and the gather of their results), summed over the cards."""

from benchmark import readers


def read(m):
    return readers.copy_ms_per_frame(m, "memcpy_ptop")
