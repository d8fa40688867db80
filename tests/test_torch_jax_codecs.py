"""The JAX reference's native codec library, whole before a port test that
compares against its JPEG and GIF codecs uses it.

``lanczos_tpu.io._native.native_lib()`` builds its three C++ libraries
with ``g++ -o`` straight onto their final paths, trusts any library newer
than its source, and keeps a failed load (``_tried``) for the life of the
process.  Under a parallel test run another worker may still be writing a
library that this worker finds and fails to load; every JPEG decode of
the reference then raises for the rest of the worker's life.

The tests that decode JPEG or GIF through the reference (or hold the
port's PNG bytes to the reference's native filter) take the function
fixture :func:`reference_codecs`: it waits for a library with the JPEG and
GIF decoders, up to the reference's own 120 s build limit, and fails with
the reason past that.  Before each load it waits until the libraries' size
and modification time hold still over one poll, so a file that ``g++`` is
still writing is not loaded; between loads it clears the reference's memo.
A process gives up once: a later test fails at once with the same reason,
as it does where there is no ``g++`` to build the library.  Nothing of the
reference changes.
"""

import os
import shutil
import threading
import time

import pytest

BUILD_LIMIT_S = 120.0  # the reference's own g++ timeout (lanczos_tpu/io/_native)
NEEDED = ("jpeg_decode_scan", "gif_lzw_decode")
LIBRARIES = ("_SO", "_JPEG_SO", "_LZW_SO")  # the module's paths of its built libraries
_GAVE_UP: dict = {}  # module -> why this process stopped waiting for it


def _stamps(native) -> list:
    """(size, mtime) of each built library of ``native`` (None if absent)."""
    out = []
    for name in LIBRARIES:
        try:
            st = os.stat(getattr(native, name))
            out.append((st.st_size, st.st_mtime_ns))
        except (AttributeError, OSError):
            out.append(None)
    return out


def _settle(native, poll_s, sleep, clock, deadline) -> None:
    """Return once the libraries' stamps are the same one poll apart (or at
    ``deadline``)."""
    last = _stamps(native)
    while True:
        sleep(poll_s)
        now = _stamps(native)
        if now == last or clock() >= deadline:
            return
        last = now


def whole_native_lib(native=None, limit_s: float = BUILD_LIMIT_S, poll_s: float = 0.25,
                     clock=time.monotonic, sleep=time.sleep, compiler: str = "g++"):
    """``native.native_lib()`` (default ``lanczos_tpu.io._native``) once it
    holds every symbol of :data:`NEEDED`: while one is missing, wait for the
    library files to hold still, clear the module's ``_lib`` and ``_tried``
    and load again, until ``limit_s`` has passed; then fail the test with
    what is missing.  Without ``compiler`` nothing can build the library,
    so it fails at once."""
    if native is None:
        from lanczos_tpu.io import _native as native
    if native in _GAVE_UP:
        pytest.fail(_GAVE_UP[native], pytrace=False)
    deadline = clock() + limit_s
    if native._lib is None and not native._tried:  # this load may find a half-written file
        _settle(native, poll_s, sleep, clock, deadline)
    while True:
        lib = native.native_lib()
        missing = [s for s in NEEDED if not hasattr(lib, s)]
        if not missing:
            return lib
        why = None
        if shutil.which(compiler) is None:
            why = f"no {compiler} to build it"
        elif clock() >= deadline:
            why = f"after {limit_s:.0f} s of retries ({compiler} at {shutil.which(compiler)})"
        if why:
            _GAVE_UP[native] = (f"the reference's native codec library lacks {missing} {why}: "
                                "its JPEG and GIF comparisons cannot run")
            pytest.fail(_GAVE_UP[native], pytrace=False)
        _settle(native, poll_s, sleep, clock, deadline)
        with native._lock:
            native._lib, native._tried = None, False


@pytest.fixture
def reference_codecs():
    """The reference's codec library with its JPEG and GIF decoders."""
    return whole_native_lib()


class _FakeNative:
    """A stand-in for ``lanczos_tpu.io._native`` whose ``native_lib()``
    memoizes as the reference does and returns ``libs`` one a load."""

    def __init__(self, libs, so=None):
        self._lock, self._lib, self._tried, self.loads = threading.Lock(), None, False, 0
        self._libs = iter(libs)
        if so is not None:
            self._SO = str(so)

    def native_lib(self):
        if self._lib is not None or self._tried:
            return self._lib
        self._tried = True
        self.loads += 1
        self._lib = next(self._libs)
        return self._lib


class _Lib:
    def __init__(self, *names):
        for n in names:
            setattr(self, n, object())


def test_the_reference_library_is_whole(reference_codecs):
    assert all(callable(getattr(reference_codecs, s)) for s in NEEDED)


@pytest.mark.parametrize("failures", [
    [None],  # the library failed to load (a half-written file)
    [_Lib("png_filter")],  # loaded before the JPEG and GIF libraries were whole
    [None, _Lib("jpeg_decode_scan"), None],
])
def test_waits_through_partial_loads(failures):
    whole = _Lib(*NEEDED)
    mod = _FakeNative(failures + [whole])
    naps = []
    # the first load waits one poll for the files to hold still, each retry one more
    assert whole_native_lib(mod, poll_s=0.5, sleep=naps.append, compiler="sh") is whole
    assert mod.loads == len(failures) + 1 and naps == [0.5] * (len(failures) + 1)
    assert mod._lib is whole and mod._tried


def test_waits_while_a_library_is_still_written(tmp_path):
    so = tmp_path / "libjpegdec.so"
    so.write_bytes(b"\x7fELF")
    mod = _FakeNative([None, _Lib(*NEEDED)], so=so)
    naps = []

    def sleep(s):  # the compiler appends to the file for the first three polls
        naps.append(s)
        if len(naps) <= 3:
            with open(so, "ab") as f:
                f.write(b"\0" * 64)

    whole_native_lib(mod, poll_s=0.1, sleep=sleep, compiler="sh")
    # before the first load: 3 polls that saw the file grow and 1 that saw it still;
    # before the retry: 1 more
    assert mod.loads == 2 and len(naps) == 5


def test_fails_with_the_reason_past_the_limit():
    now = [0.0]

    def sleep(s):
        now[0] += s

    mod = _FakeNative(iter(lambda: _Lib("png_filter", "gif_lzw_decode"), None))
    with pytest.raises(pytest.fail.Exception, match=r"lacks \['jpeg_decode_scan'\] after 3 s"):
        whole_native_lib(mod, limit_s=3.0, poll_s=1.0, clock=lambda: now[0], sleep=sleep,
                         compiler="sh")
    assert mod.loads == 3
    # the process gave up once: the next test fails at once, loading nothing
    with pytest.raises(pytest.fail.Exception, match=r"after 3 s"):
        whole_native_lib(mod, sleep=sleep, compiler="sh")
    assert mod.loads == 3


def test_fails_at_once_without_a_compiler():
    mod = _FakeNative([None, _Lib(*NEEDED)])
    naps = []
    with pytest.raises(pytest.fail.Exception, match="no no-such-compiler to build it"):
        whole_native_lib(mod, sleep=naps.append, compiler="no-such-compiler")
    assert mod.loads == 1 and len(naps) == 1
