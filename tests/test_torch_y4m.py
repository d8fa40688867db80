"""The port's copy of the Y4M container (``lanczos_torch.io.y4m``) against
the original on the same streams, and ``upscale_y4m`` of both packages on
the same bytes.

Limits: the container functions identical results; ``profile="hls"``
(integer arithmetic) an identical output file; ``precise`` with
``backend="xla"`` identical headers and every plane within
``test_torch_gather.py``'s limits (≤ 1 LSB on ≤ 1% of pixels); every plane
identical bytes to the port's ``Upscaler.planar`` on that plane.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.io import y4m as tpu_y4m  # noqa: E402
from lanczos_tpu.models.video import upscale_y4m as tpu_upscale_y4m  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.io import y4m  # noqa: E402

COLORSPACES = ["420jpeg", "420mpeg2", "420paldv", "422", "444", "mono", "420p10"]
_DIV = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}


def _frames(n, h, w, cs="420jpeg", seed=42):
    rng = np.random.default_rng(seed)
    deep = cs.endswith("p10")
    top, dt = (1024, np.uint16) if deep else (256, np.uint8)
    out = []
    for _ in range(n):
        y = rng.integers(0, top, size=(h, w), dtype=dt)
        if cs == "mono":
            out.append((y,))
            continue
        dh, dw = _DIV[cs[:3]]
        out.append((y,) + tuple(
            rng.integers(0, top, size=(h // dh, w // dw), dtype=dt) for _ in range(2)))
    return out


def _stream(cs, n=3, h=32, w=48):
    buf = io.BytesIO()
    tpu_y4m.write_y4m(buf, _frames(n, h, w, cs), fps=(30000, 1001), colorspace=cs)
    return buf.getvalue()


@pytest.mark.parametrize("cs", COLORSPACES)
def test_reader_and_header_equal_the_originals(cs):
    data = _stream(cs)
    line = data.split(b"\n", 1)[0]
    got, want = y4m.parse_header(line), tpu_y4m.parse_header(line)
    assert vars(got) == vars(want)
    for name in ("bit_depth", "base_colorspace", "chroma_shape", "frame_bytes", "sample_dtype"):
        assert getattr(got, name) == getattr(want, name)
    hdr, frames = y4m.read_y4m(data)
    thdr, tframes = tpu_y4m.read_y4m(data)
    assert vars(hdr) == vars(thdr) and len(frames) == len(tframes) == 3
    for f, tf in zip(frames, tframes):
        assert len(f) == len(tf)
        for p, tp in zip(f, tf):
            assert p.dtype == tp.dtype
            np.testing.assert_array_equal(p, tp)
    with y4m.Y4MReader(io.BytesIO(data)) as reader:
        assert len(list(reader)) == 3


@pytest.mark.parametrize("cs", COLORSPACES)
def test_writer_bytes_equal_the_originals(cs):
    frames = _frames(3, 32, 48, cs)
    buf = io.BytesIO()
    hdr = y4m.write_y4m(buf, frames, fps=(30000, 1001), colorspace=cs)
    assert buf.getvalue() == _stream(cs)
    assert hdr.colorspace == cs and hdr.fps == (30000, 1001)
    buf2 = io.BytesIO()
    with y4m.Y4MWriter(buf2, hdr) as writer:
        for f in frames:
            writer.write(f)
    assert buf2.getvalue() == buf.getvalue()


def test_colorspace_inferred_and_errors_as_the_originals():
    for cs in ("422", "mono", "444"):
        frames = _frames(1, 16, 16, cs)
        assert (y4m.write_y4m(io.BytesIO(), frames).colorspace
                == tpu_y4m.write_y4m(io.BytesIO(), frames).colorspace)
    bad = [b"NOTY4M W2 H2", b"YUV4MPEG2 W640 H480 It", b"YUV4MPEG2 W641 H480 C420jpeg",
           b"YUV4MPEG2 W8 H6 Cmonop10"]
    for line in bad:
        with pytest.raises(tpu_y4m.Y4MError):
            tpu_y4m.parse_header(line)
        with pytest.raises(y4m.Y4MError):
            y4m.parse_header(line)
    assert issubclass(y4m.Y4MError, ValueError)
    with pytest.raises(y4m.Y4MError, match="truncated"):
        y4m.read_y4m(_stream("mono", n=2, h=8, w=8)[:-5])
    yy = np.zeros((16, 16), np.uint8)
    with pytest.raises(y4m.Y4MError, match="subsampling"):
        y4m.write_y4m(io.BytesIO(), [(yy, yy[:, :4], yy[:, :4])])
    with pytest.raises(y4m.Y4MError, match="exceeds"):
        y4m.write_y4m(io.BytesIO(), [(np.full((6, 8), 2000, np.uint16),) + (
            np.zeros((3, 4), np.uint16),) * 2], colorspace="420p10")
    assert lanczos_torch.io.Y4MReader is y4m.Y4MReader


def test_frame_params_and_short_reads():
    data = _stream("420jpeg", n=4, h=16, w=16).replace(b"FRAME\n", b"FRAME Xsome-param\n")

    class Dribble(io.RawIOBase):
        def __init__(self, data):
            self.data, self.pos = data, 0

        def readable(self):
            return True

        def read(self, n=-1):
            n = 3 if n is None or n < 0 else min(n, 3)
            out = self.data[self.pos : self.pos + n]
            self.pos += len(out)
            return out

    got = list(y4m.Y4MReader(Dribble(data)))
    want = list(tpu_y4m.Y4MReader(Dribble(data)))
    assert len(got) == len(want) == 4
    for g, t in zip(got, want):
        for gp, tp in zip(g, t):
            np.testing.assert_array_equal(gp, tp)


def _write(path, cs, n=5, h=24, w=32, seed=42):
    frames = _frames(n, h, w, cs, seed)
    y4m.write_y4m(str(path), frames, fps=(24, 1), colorspace=cs)
    return frames


@pytest.mark.parametrize("cs", ["420jpeg", "mono"])
def test_upscale_y4m_hls_file_equals_the_references(cs, tmp_path):
    _write(tmp_path / "in.y4m", cs)
    args = dict(scale=(2, 1), a=2, profile="hls", batch=2)
    hdr = lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "port.y4m"),
                                    device="cpu", **args)
    thdr = tpu_upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "ref.y4m"), **args)
    assert vars(hdr) == vars(thdr) and (hdr.width, hdr.height) == (64, 48)
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "ref.y4m").read_bytes()


@pytest.mark.parametrize("cs,backend", [("420jpeg", "xla"), ("mono", "xla"), ("422", "xla"),
                                        ("444", "auto"), ("420jpeg", "auto")])
def test_upscale_y4m_precise_planes(cs, backend, tmp_path):
    """5 frames at batch 2 (a tail batch of one): each plane identical to
    ``Upscaler.planar`` on it; with ``backend="xla"`` the header equal to
    the reference's and each plane within the gather limits of its."""
    frames = _write(tmp_path / "in.y4m", cs)
    args = dict(scale=(2, 1), a=2, batch=2, backend=backend)
    hdr = lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "port.y4m"),
                                    device="cpu", **args)
    hdr2, got = y4m.read_y4m(str(tmp_path / "port.y4m"))
    assert hdr2 == hdr and hdr.colorspace == cs and hdr.fps == (24, 1) and len(got) == 5
    ups = {}
    for src_f, out_f in zip(frames, got):
        for p_in, p_out in zip(src_f, out_f):
            if p_in.shape not in ups:
                ups[p_in.shape] = lanczos_torch.Upscaler(
                    lanczos_torch.ResampleConfig.from_profile(
                        "precise", p_in.shape, scale=(2, 1), a=2),
                    backend=backend, device="cpu")
            want = ups[p_in.shape].planar(torch.from_numpy(p_in[None]))[0].numpy()
            np.testing.assert_array_equal(p_out, want)
    if backend == "xla":
        thdr = tpu_upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "ref.y4m"), **args)
        assert vars(hdr) == vars(thdr)
        _, ref = tpu_y4m.read_y4m(str(tmp_path / "ref.y4m"))
        for out_f, ref_f in zip(got, ref):
            for p, r in zip(out_f, ref_f):
                d = np.abs(p.astype(int) - r.astype(int))
                assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_upscale_y4m_subsampling_guard(tmp_path):
    """A scale that breaks 4:2:0 chroma alignment raises, not corrupts."""
    y4m.write_y4m(str(tmp_path / "in.y4m"), _frames(1, 12, 12, "420jpeg"))
    for fn, kw in ((lanczos_torch.upscale_y4m, {"device": "cpu"}), (tpu_upscale_y4m, {})):
        with pytest.raises(ValueError):
            fn(str(tmp_path / "in.y4m"), str(tmp_path / "o.y4m"), scale=(3, 4), a=2, **kw)
    y4m.write_y4m(str(tmp_path / "odd.y4m"), _frames(1, 20, 20, "420jpeg"))
    with pytest.raises(y4m.Y4MError, match="subsampling"):
        lanczos_torch.upscale_y4m(str(tmp_path / "odd.y4m"), str(tmp_path / "o.y4m"),
                                  out_shape=(30, 31), a=2, device="cpu")


def test_upscale_y4m_out_shape(tmp_path):
    """out_shape (instead of scale) maps chroma proportionally."""
    _write(tmp_path / "in.y4m", "420jpeg", n=2)
    hdr = lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "o.y4m"),
                                    out_shape=(72, 96), a=2, batch=2, device="cpu")
    assert (hdr.width, hdr.height) == (96, 72)
    _, got = y4m.read_y4m(str(tmp_path / "o.y4m"))
    assert got[0][0].shape == (72, 96) and got[0][1].shape == (36, 48)


def test_upscale_y4m_ref_backend(tmp_path):
    """The host-oracle backend returns floats: trunc-clipped to bytes
    before writing, within 1 LSB of the block path."""
    _write(tmp_path / "in.y4m", "420jpeg", n=3, h=16, w=16)
    for backend in ("ref", "block"):
        lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / f"{backend}.y4m"),
                                  scale=(2, 1), a=2, backend=backend, batch=2, device="cpu")
    _, ref = y4m.read_y4m(str(tmp_path / "ref.y4m"))
    _, dev = y4m.read_y4m(str(tmp_path / "block.y4m"))
    assert len(ref) == len(dev) == 3
    for rf, df in zip(ref, dev):
        for rp, dp in zip(rf, df):
            assert np.abs(rp.astype(int) - dp.astype(int)).max() <= 1


def test_upscale_y4m_deep(tmp_path):
    """A 10-bit stream: uint16 planes through the float path, clamped to
    the stream's range; planes within 1 LSB on ≤ 1% of the reference's."""
    frames = _write(tmp_path / "in.y4m", "420p10", n=3, h=16, w=12)
    args = dict(scale=(2, 1), a=2, batch=2)
    hdr = lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "port.y4m"),
                                    device="cpu", **args)
    thdr = tpu_upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "ref.y4m"), **args)
    assert vars(hdr) == vars(thdr) and hdr.colorspace == "420p10"
    assert (hdr.width, hdr.height) == (24, 32)
    _, got = y4m.read_y4m(str(tmp_path / "port.y4m"))
    _, ref = tpu_y4m.read_y4m(str(tmp_path / "ref.y4m"))
    assert len(got) == len(ref) == 3
    for gf, rf in zip(got, ref):
        assert gf[0].shape == (32, 24) and gf[0].dtype == np.uint16 and gf[1].shape == (16, 12)
        for g, r in zip(gf, rf):
            assert g.max() <= 1023  # overshoot clamped to the 10-bit range
            d = np.abs(g.astype(int) - r.astype(int))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 12), scale=(2, 1), a=2,
                                                    channels=1)
    want = lanczos_torch.Upscaler(cfg, device="cpu")(
        torch.from_numpy(frames[0][0][..., None].astype(np.uint16)))[..., 0].numpy()
    np.testing.assert_array_equal(got[0][0], np.minimum(want, 1023).astype(np.uint16))


def test_upscale_y4m_closes_its_reader_when_the_writer_fails(tmp_path):
    """A failing launch leaves no read-ahead thread behind."""
    import threading

    _write(tmp_path / "in.y4m", "420jpeg", n=6)
    before = threading.active_count()
    with pytest.raises(ValueError, match="unknown backend"):
        lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "o.y4m"),
                                  scale=(2, 1), backend="tpu", device="cpu")
    with pytest.raises(OSError):
        lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "no" / "o.y4m"),
                                  scale=(2, 1), device="cpu")
    assert threading.active_count() <= before


@pytest.mark.parametrize("cs,profile,backend", [("420jpeg", "precise", "auto"),
                                                ("444", "precise", "gather"),
                                                ("mono", "hls", "auto")])
def test_upscale_y4m_on_a_mesh_equals_no_mesh(cs, profile, backend, tmp_path):
    """mesh=: each plane batch sharded over (data × rows), the batch rounded
    up to the data axis; the file identical to the unsharded run's."""
    from lanczos_torch.parallel.mesh import Mesh

    _write(tmp_path / "in.y4m", cs)
    args = dict(scale=(2, 1), a=2, profile=profile, batch=3)
    mesh = Mesh.local(["cpu"] * 4, (2, 2))
    hdr = lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "mesh.y4m"),
                                    mesh=mesh, backend=backend, **args)
    want = lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "one.y4m"),
                                     device="cpu", backend="xla" if backend == "gather"
                                     else "auto", **args)
    assert vars(hdr) == vars(want)
    assert (tmp_path / "mesh.y4m").read_bytes() == (tmp_path / "one.y4m").read_bytes()
