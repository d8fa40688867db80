"""The least time an H100 could take for a resample, frozen here so that a
change to the program cannot move the yardstick.

The count is the one ``lanczos_torch/utils/profiling.py`` ``kernel_bound``
makes, copied: every input byte read once and every output byte written
once (uint8 planes), and two operations a multiply-add, with
``2·a·max(1, D/N)`` taps a value in each pass (height first: the vertical
pass makes OH × W values, the horizontal OH × OW).  The peaks are NVIDIA's
data sheet for the H100 SXM card at 700 W: HBM3 at 3.35 TB/s, and 67 TFLOP/s
of fp32 outside the tensor cores (the port's kernels sum in fp32 on the
CUDA cores).
"""

from __future__ import annotations

from math import gcd

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def _taps(n_in: int, n_out: int, a: int) -> float:
    g = gcd(n_in, n_out)
    n, d = n_out // g, n_in // g
    return 2 * a * max(1.0, d / n)


def resample_bound(in_shape, out_shape, a: int, planes: int) -> dict:
    """``bytes``, ``flops``, ``seconds`` (the larger of the two times at the
    peaks) and ``by`` (``"bytes"`` or ``"operations"``) of resampling
    ``planes`` uint8 planes of ``in_shape`` to ``out_shape``."""
    (ih, iw), (oh, ow) = in_shape, out_shape
    nbytes = planes * (ih * iw + oh * ow)
    flops = 2.0 * planes * (oh * iw * _taps(ih, oh, a) + oh * ow * _taps(iw, ow, a))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / FP32_FLOPS_PER_S
    return dict(bytes=nbytes, flops=flops, seconds=max(t_bytes, t_flops),
                by="bytes" if t_bytes >= t_flops else "operations")
