"""The port's ``FrameLoader`` / ``FrameWriter`` (copies of
``lanczos_tpu.io.loader``) against the originals, and files in → files out
through ``VideoUpscaler`` on the CPU.

Limits: the loaders yield the same paths in the same order and identical
arrays; the writers write identical bytes; an error surfaces at ``close``
as the same exception type in both; every frame of the pipeline identical
bytes to ``Upscaler`` on that frame.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.io import write_image as twrite  # noqa: E402
from lanczos_tpu.io.loader import FrameLoader as TLoader, FrameWriter as TWriter  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.io import read_image  # noqa: E402
from lanczos_torch.io.loader import FrameLoader, FrameWriter  # noqa: E402

from test_torch_jax_codecs import reference_codecs  # noqa: E402,F401

EXTS = ["png", "jpg", "bmp", "tga", "ppm", "gif"]


def _files(tmp_path, n, shape=(12, 10, 3), seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for k in range(n):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        p = tmp_path / f"f{k:03d}.{EXTS[k % len(EXTS)]}"
        twrite(p, img)
        paths.append(p)
    return paths


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("workers,prefetch", [(1, 1), (3, 4), (4, 16)])
def test_loader_order_and_content_equal(tmp_path, workers, prefetch):
    paths = _files(tmp_path, 11)
    got = list(FrameLoader(paths, decode_workers=workers, prefetch=prefetch))
    want = list(TLoader(paths, decode_workers=workers, prefetch=prefetch))
    assert len(FrameLoader(paths)) == 11
    assert [p for p, _ in got] == [p for p, _ in want] == [str(p) for p in paths]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.usefixtures("reference_codecs")
def test_loader_transform_and_error_equal(tmp_path):
    paths = _files(tmp_path, 3)
    t = lambda im: im[..., :1]  # noqa: E731
    for (_, g), (_, w) in zip(FrameLoader(paths, transform=t), TLoader(paths, transform=t)):
        assert g.shape == (12, 10, 1)
        np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(20))
    errs = []
    for loader in (FrameLoader, TLoader):
        with pytest.raises(ValueError) as e:
            list(loader(paths + [bad]))
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


@pytest.mark.usefixtures("reference_codecs")
@pytest.mark.parametrize("level", [1, 6, 9])
def test_writer_bytes_equal(tmp_path, level):
    rng = np.random.default_rng(level)
    imgs = [rng.integers(0, 256, (9, 7, 3), dtype=np.uint8) for _ in range(6)]
    for tag, writer in (("p", FrameWriter), ("t", TWriter)):
        (tmp_path / tag).mkdir()
        with writer(encode_workers=2, compress_level=level, max_pending=2) as w:
            for k, img in enumerate(imgs):
                w.write(tmp_path / tag / f"o{k}.{EXTS[k]}", img)
    for k in range(6):
        name = f"o{k}.{EXTS[k]}"
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()


def test_writer_error_surfaces_at_close(tmp_path):
    errs = []
    for writer in (FrameWriter, TWriter):
        w = writer(encode_workers=1)
        w.write(tmp_path / "missing" / "o.png", np.zeros((4, 4, 3), np.uint8))
        with pytest.raises(OSError) as e:
            w.close()
        errs.append(type(e.value).__name__)
    assert errs[0] == errs[1] == "FileNotFoundError"


def test_writer_backpressure_under_many_threads(tmp_path):
    """More writing threads than encode workers and pending slots, with a
    short switch interval: every file lands, with its own bytes."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        imgs = [np.full((5, 5, 3), k, np.uint8) for k in range(24)]
        with FrameWriter(encode_workers=2, max_pending=3) as w:
            threads = [threading.Thread(target=w.write, args=(tmp_path / f"o{k}.png", imgs[k]))
                       for k in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for k in range(24):
        np.testing.assert_array_equal(read_image(tmp_path / f"o{k}.png"), imgs[k])


@pytest.mark.parametrize("batch", [1, 3])
def test_files_in_files_out_equal_the_upscaler(tmp_path, batch):
    """FrameLoader → VideoUpscaler → FrameWriter on the CPU (the plain
    versions), each output identical to ``Upscaler`` on its frame."""
    paths = _files(tmp_path, 5, shape=(16, 24, 3), seed=batch)
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1), a=3)
    vu = lanczos_torch.VideoUpscaler(cfg, batch=batch, device="cpu")
    loader = FrameLoader(paths, decode_workers=2)
    names = [p for p, _ in loader]
    with FrameWriter(encode_workers=2) as w:
        for k, out in enumerate(vu.frames(img for _, img in loader)):
            w.write(tmp_path / f"up{k}.png", out)
    model = lanczos_torch.Upscaler(cfg, device="cpu")
    assert len(names) == len(paths)
    for k, name in enumerate(names):
        want = model(read_image(name)).numpy()
        np.testing.assert_array_equal(read_image(tmp_path / f"up{k}.png"), want)
