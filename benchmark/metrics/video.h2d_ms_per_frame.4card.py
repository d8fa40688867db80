"""Device milliseconds a frame of the traced window's copies from the host to
a card (``Memcpy HtoD``), summed over the four cards."""

from benchmark import readers


def read(m):
    return readers.copy_ms_per_frame(m, "memcpy_htod")
