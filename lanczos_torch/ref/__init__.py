"""The host NumPy oracles, copied from ``lanczos_tpu.ref`` with only the
imports changed, so that the port imports no JAX."""

from lanczos_torch.ref.oracle import (  # noqa: F401
    c_oracle_upscale,
    clean_resample_2d,
    oracle_resample_axis0,
)
from lanczos_torch.ref.hls_sim import hls_stream_upscale  # noqa: F401
