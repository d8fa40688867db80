"""lanczos_torch — the PyTorch/CUDA port of ``lanczos_tpu`` for one NVIDIA
H100.

It imports torch and never JAX.  This slice covers the main path: a
uint8 ``precise`` (linear, fp32 or bf16) upscale through
:func:`upscale` / :class:`Upscaler`, on a hand-written CUDA kernel
(``csrc/fused_resample.cu``) built with ``nvcc`` at first use.  Every
other config raises ``NotImplementedError`` naming its slice.

    - ``lanczos_torch.core``:   configuration, filter kernels, weight tables
      (copies of ``lanczos_tpu.core``'s framework-neutral modules)
    - ``lanczos_torch.ops``:    the fused plan, kernel wrapper and its
      plain PyTorch version
    - ``lanczos_torch.models``: :class:`Upscaler` and :func:`upscale`
    - ``lanczos_torch.utils``:  metrics and CUDA-event timing
"""

__version__ = "0.1.0"

from lanczos_torch.core.config import (  # noqa: F401
    Align,
    EdgeMode,
    Order,
    Precision,
    Profile,
    ResampleConfig,
)
from lanczos_torch.models.upscaler import Upscaler, upscale  # noqa: F401
