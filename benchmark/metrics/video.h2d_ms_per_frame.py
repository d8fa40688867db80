"""Device milliseconds a frame of the traced window's copies from the host to
a card (``Memcpy HtoD``), on one card."""

from benchmark import readers


def read(m):
    return readers.copy_ms_per_frame(m, "memcpy_htod")
