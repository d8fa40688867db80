"""The host NumPy oracles, copied from ``lanczos_tpu.ref`` with only the
imports changed, so that the port imports no JAX, and the float64 gather
the card is certified against (``gather.py``, the port's own)."""

from lanczos_torch.ref.oracle import (  # noqa: F401
    c_oracle_upscale,
    clean_resample_2d,
    oracle_resample_axis0,
)
from lanczos_torch.ref.hls_sim import hls_stream_upscale  # noqa: F401
from lanczos_torch.ref.gather import gather_f64  # noqa: F401
