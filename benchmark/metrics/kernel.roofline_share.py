"""The fused kernel's share of its roofline, in percent: the frozen bound
of the traced window's frames over the device time of every
``fused_resample_kernel`` launch in it."""

from benchmark import readers


def read(m):
    return readers.roofline_share(m)
