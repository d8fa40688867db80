from lanczos_torch.core.config import (  # noqa: F401
    Align,
    EdgeMode,
    Order,
    Precision,
    Profile,
    ResampleConfig,
)
from lanczos_torch.core import filters, weights  # noqa: F401
