"""Device time and peak device memory of the tensor-op paths at 4K→8K.

    python -m lanczos_torch.tools.time_paths [xla] [shift_xla] [block] ...

Each named backend of ``Upscaler`` (default ``xla`` and ``shift_xla``) on
a 2160×3840×3 uint8 frame (uniform noise from
``numpy.random.default_rng(0)``) to 4320×7680, Lanczos-3, ``precise``, in
fp32 and bf16: ms/frame from CUDA events (mean of 20 calls after 3), and
the peak of device memory one call allocates beyond the frame, printed
with the card's name and power limit.  The file also runs as a script
against another checkout of the package (``PYTHONPATH=<checkout> python
lanczos_torch/tools/time_paths.py``), so two versions can be timed in
one run on one card.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

FRAME = (2160, 3840)


def main(argv=None) -> int:
    import lanczos_torch
    from lanczos_torch.utils.timing import cuda_time_ms

    backends = (sys.argv[1:] if argv is None else argv) or ["xla", "shift_xla"]
    if not torch.cuda.is_available():
        print("time_paths: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, FRAME + (3,), dtype=np.uint8)).cuda()
    print(f"lanczos_torch from {lanczos_torch.__file__} [{smi}]", flush=True)
    for backend in backends:
        for precision in ("fp32", "bf16"):
            cfg = lanczos_torch.ResampleConfig.from_profile(
                "precise", FRAME, scale=(2, 1), a=3, precision=precision)
            up = lanczos_torch.Upscaler(cfg, backend=backend)
            up(x)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = up(x)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            del y
            ms = cuda_time_ms(up, x)
            print(f"{backend} {precision} 4K->8K: {ms:.4f} ms/frame, peak {peak:.3f} GiB "
                  f"beyond the frame", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
