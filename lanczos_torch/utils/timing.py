"""Device timing with CUDA events.

PyTorch returns before the card finishes, so a host clock measures the
enqueue; events recorded on the stream around the launches, and a
synchronize before reading them, measure the card.  There is no CPU
version: a number taken on the CPU is not a device time.
"""

from __future__ import annotations

from typing import Callable

import torch


def cuda_time_ms(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(*args)`` on the current
    CUDA stream, after ``warmup`` untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sync_cards() -> None:
    """Wait for every visible card: a sharded call spans all of them, and an
    event sees one card's stream only (none on the CPU)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
