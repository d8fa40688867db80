"""Device milliseconds a frame of the traced window's copies from a card to
the host (``Memcpy DtoH``), on one card."""

from benchmark import readers


def read(m):
    return readers.copy_ms_per_frame(m, "memcpy_dtoh")
