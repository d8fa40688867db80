"""Build a host C++ source with ``g++`` at first use.

The library goes to ``lanczos_torch/_build/`` (never beside its source),
named by a hash of the source and the flags, and is renamed into place from
a private temporary directory, so processes that build the same source at
once never load a half-written file.  The native oracle loop and the image
codecs' inner loops are built this way; each caller keeps a NumPy path (or
raises) where the build fails.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def library_path(src: Path, flags: Sequence[str], stem: str) -> Path:
    """Where the library of ``src`` built with ``flags`` lives."""
    h = hashlib.sha256(" ".join(flags).encode() + Path(src).read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_library(src: Path, flags: Sequence[str], stem: str) -> Optional[Path]:
    """The path of ``src``'s shared library, built first if it is not there
    yet; None where ``g++`` is missing or fails."""
    so = library_path(src, flags, stem)
    if so.exists():
        return so
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, so.name)
            subprocess.run(
                ["g++", *flags, "-o", out, str(src)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(out, so)
    except (OSError, subprocess.SubprocessError):
        return None
    return so
