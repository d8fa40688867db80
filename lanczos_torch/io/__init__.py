"""Container I/O of the port: the Y4M video container only, so far.

:mod:`lanczos_torch.io.y4m` is a copy of ``lanczos_tpu/io/y4m.py`` (numpy
only).  The image codecs (PNG, JPEG, the other formats, the loader) of
``lanczos_tpu.io`` are not ported yet.
"""

from lanczos_torch.io.y4m import (  # noqa: F401
    Y4MError,
    Y4MHeader,
    Y4MReader,
    Y4MWriter,
    parse_header,
    read_y4m,
    write_y4m,
)
