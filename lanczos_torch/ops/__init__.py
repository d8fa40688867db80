"""The tensor-op paths' names as ``lanczos_tpu.ops`` exports them
(``resample_2d_gather`` is ``resample_2d_xla``'s counterpart,
``hls_upscale`` ``hls_upscale_xla``'s).  The kernels' wrappers
(``resample_cuda``, ``resample_shift_cuda``, ``resample_phase_cuda``) are
imported where they are used, never here."""

from lanczos_torch.ops.resample_gather import (  # noqa: F401
    apply_banded,
    quantize_uint8,
    resample_2d_gather,
)
from lanczos_torch.ops.fixed_point import hls_upscale  # noqa: F401
