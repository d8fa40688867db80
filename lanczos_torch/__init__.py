"""lanczos_torch — the PyTorch/CUDA port of ``lanczos_tpu`` for one NVIDIA
H100.

It imports torch and never JAX.  It covers uint8 ``precise``-family
upscales (fp32 or bf16; linear, with the FSR dering clamp, with the
uint8-quantized intermediate, either pass order) through :func:`upscale`
/ :class:`Upscaler`, on hand-written CUDA kernels built with ``nvcc`` at
first use: the fused kernel (``csrc/fused_resample.cu``) and, for
integer-scale dering without a fused plan, the shift-FMA kernel
(``csrc/shift_resample.cu``).  Every other config raises
``NotImplementedError`` naming its slice.

    - ``lanczos_torch.core``:   configuration, filter kernels, weight tables
      (copies of ``lanczos_tpu.core``'s framework-neutral modules)
    - ``lanczos_torch.ops``:    the plans, the kernels' wrappers, their
      plain PyTorch versions and the routing between them
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
