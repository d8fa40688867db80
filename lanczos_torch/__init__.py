"""lanczos_torch — the PyTorch/CUDA port of ``lanczos_tpu`` for one NVIDIA
H100.

It imports torch and never JAX.  :func:`upscale` / :class:`Upscaler` run
the three profiles (``precise``, ``hls``, ``c_oracle``), every
single-device backend of the JAX package (``auto``, ``pallas`` and the
port's ``cuda``, ``shift_xla``, ``block``, ``xla``, ``c_exact``, ``ref``)
and its dtype contract (uint8, uint16 and float input).  The uint8
``precise`` paths run on hand-written CUDA kernels built with ``nvcc`` at
first use (``csrc/``); the float paths and the bit-exact profiles run as
PyTorch tensor ops on the input's device.  :class:`StreamingUpscaler`
(row chunks of a frame of any height), :class:`VideoUpscaler` and
:func:`upscale_y4m` (frame sequences, ``.y4m`` files) keep chunks and
frame batches in flight between the host and one card.
:class:`ShardedUpscaler` and :class:`ShardedStreamingUpscaler`, and
``mesh=`` on :func:`upscale`, :class:`VideoUpscaler` and :func:`upscale_y4m`,
split rows and frames over a (data × rows) :class:`Mesh` of devices: one
process's (``Mesh.local``; on one card the shards run one after another) or
the ranks of a ``torch.distributed`` group (``Mesh.distributed``, after
``parallel.multihost.initialize``).  ``python -m lanczos_torch in.png
out.png --scale 2/1`` is the command line (``lanczos_torch.cli``), and
``lanczos_torch.io`` reads and writes the image files and ``.y4m`` video.

    - ``lanczos_torch.core``:   configuration, filter kernels, weight tables
      (copies of ``lanczos_tpu.core``'s framework-neutral modules)
    - ``lanczos_torch.ref``:    the host NumPy oracles (copies of
      ``lanczos_tpu.ref``)
    - ``lanczos_torch.ops``:    the plans, the kernels' wrappers, their
      plain PyTorch versions, the tensor-op paths and the routing
    - ``lanczos_torch.models``: :class:`Upscaler` and :func:`upscale`,
      streaming and video
    - ``lanczos_torch.parallel``: the mesh and its halo exchange, row and
      batch sharding, multi-process set-up and the scaling models
    - ``lanczos_torch.io``:     the image codecs, the frame loader and
      writer and the Y4M container (copies of ``lanczos_tpu.io``)
    - ``lanczos_torch.utils``:  metrics, CUDA-event timing and the host
      C++ build
    - ``lanczos_torch.cli``, ``lanczos_torch.entry``: the command line and
      the entry points
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
from lanczos_torch.models.streaming import (  # noqa: F401
    ShardedStreamingUpscaler,
    StreamingUpscaler,
)
from lanczos_torch.models.video import VideoUpscaler, upscale_y4m  # noqa: F401
from lanczos_torch.parallel.mesh import Mesh  # noqa: F401
from lanczos_torch.parallel.sharded import ShardedUpscaler  # noqa: F401
