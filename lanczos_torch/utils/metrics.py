"""Accuracy metrics (the port of ``lanczos_tpu/utils/metrics.py``).

Inputs may be numpy arrays or torch tensors on any device; they are
compared on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.float64)


def rms_error(a, b) -> float:
    """RMS over all elements, computed as the reference does
    (``full_TB.h:160-166``): integer diffs, squared, averaged, sqrt."""
    a, b = _f64(a), _f64(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a, b, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB; inf for identical inputs."""
    r = rms_error(a, b)
    if r == 0.0:
        return float("inf")
    return float(20.0 * np.log10(peak / r))


def max_abs_err(a, b) -> float:
    a, b = _f64(a), _f64(b)
    if a.shape != b.shape:  # same contract as rms_error: no broadcasting
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.max(np.abs(a - b)))
