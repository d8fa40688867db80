"""Device milliseconds a frame of the kernels other than the fused kernel
in the traced window: on the interleaved path, the copies that turn
(B, H, W, C) frames into (B·C, H, W) planes."""

from benchmark import readers


def read(m):
    return readers.device_ms_per_frame(
        m, lambda o: o.kind == "kernel" and readers.FUSED not in o.name)
