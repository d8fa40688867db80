"""lanczos_torch — the PyTorch/CUDA port of ``lanczos_tpu`` for one NVIDIA
H100.

It imports torch and never JAX.  :func:`upscale` / :class:`Upscaler` run
the three profiles (``precise``, ``hls``, ``c_oracle``), every
single-device backend of the JAX package (``auto``, ``pallas`` and the
port's ``cuda``, ``shift_xla``, ``block``, ``xla``, ``c_exact``, ``ref``)
and its dtype contract (uint8, uint16 and float input).  The uint8
``precise`` paths run on hand-written CUDA kernels built with ``nvcc`` at
first use (``csrc/``); the float paths and the bit-exact profiles run as
PyTorch tensor ops on the input's device.  Streaming, video, the
multi-device paths (``mesh=``), the CLI and the image codecs are later
slices: ``mesh=`` raises ``NotImplementedError`` naming its slice.

    - ``lanczos_torch.core``:   configuration, filter kernels, weight tables
      (copies of ``lanczos_tpu.core``'s framework-neutral modules)
    - ``lanczos_torch.ref``:    the host NumPy oracles (copies of
      ``lanczos_tpu.ref``)
    - ``lanczos_torch.ops``:    the plans, the kernels' wrappers, their
      plain PyTorch versions, the tensor-op paths and the routing
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
