"""The port's copied host layers equal ``lanczos_tpu.core``'s.

``lanczos_torch.core`` holds copies of the framework-neutral config,
filter and weight modules, so that the port imports no JAX.  These tests
hold the copies to the originals: identical tables over a sweep of
scales, support radii, edge modes, alignments and normalization.
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from lanczos_tpu.core import config as tpu_config  # noqa: E402
from lanczos_tpu.core import filters as tpu_filters  # noqa: E402
from lanczos_tpu.core import weights as tpu_weights  # noqa: E402

from lanczos_torch.core import config, filters, weights  # noqa: E402

SCALES = [(2, 1), (3, 1), (3, 2), (4, 3), (1, 2)]
EDGES = ["clamp", "drop", "reflect"]
ALIGNS = ["zero", "center"]


@pytest.mark.parametrize(
    "scale,a,edge,align,normalize",
    list(itertools.product(SCALES, [2, 3], EDGES, ALIGNS, [True, False])),
)
def test_banded_weights_equal(scale, a, edge, align, normalize):
    n, d = scale
    in_size = 6 * d + 5 * n  # not a multiple of the tile or of n
    out_size = in_size * n // d if in_size * n % d == 0 else in_size * n // d + 1
    kw = dict(edge_mode=edge, normalize=normalize, align=align)
    got = weights.banded_weights(in_size, out_size, a, **kw)
    want = tpu_weights.banded_weights(
        in_size, out_size, a, edge_mode=tpu_config.EdgeMode(edge),
        normalize=normalize, align=align,
    )
    assert (got.in_size, got.out_size, got.a) == (want.in_size, want.out_size, want.a)
    for field in ("idx", "weights", "base"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype
        assert np.array_equal(g, w), field


@pytest.mark.parametrize(
    "scale,a,align,normalize",
    list(itertools.product(SCALES, [2, 3], ALIGNS, [True, False])),
)
def test_phase_tables_equal(scale, a, align, normalize):
    n, d = scale
    support = a if n >= d else -(-(a * d) // n)
    got = weights.phase_table(n, d, a, support, "lanczos", normalize, align)
    want = tpu_weights.phase_table(n, d, a, support, "lanczos", normalize, align)
    assert np.array_equal(got, want)
    pw, pw_tpu = (
        mod.PhaseWeights.build(6 * d, 6 * n, a, normalize=normalize, align=align)
        for mod in (weights, tpu_weights)
    )
    assert np.array_equal(pw.table, pw_tpu.table)
    assert np.array_equal(pw.off, pw_tpu.off)


@pytest.mark.parametrize("name", tpu_filters.available_filters())
def test_filters_equal(name):
    t = np.linspace(-4.0, 4.0, 161)
    assert filters.available_filters() == tpu_filters.available_filters()
    assert np.array_equal(filters.get_filter(name)(t, 3),
                          tpu_filters.get_filter(name)(t, 3))


@pytest.mark.parametrize("profile", ["precise", "c_oracle", "hls"])
def test_profiles_equal(profile):
    got = config.ResampleConfig.from_profile(profile, (48, 40), scale=(3, 2), a=2)
    want = tpu_config.ResampleConfig.from_profile(profile, (48, 40), scale=(3, 2), a=2)
    for f in got.__dataclass_fields__:
        g, w = getattr(got, f), getattr(want, f)
        assert getattr(g, "value", g) == getattr(w, "value", w), f
    assert got.scale_h == want.scale_h and got.scale_w == want.scale_w
    assert config.reduced_scale(2160, 4320) == tpu_config.reduced_scale(2160, 4320)


@pytest.mark.parametrize("mode", ["fp64", "hls"])
@pytest.mark.parametrize("a,n,p", list(itertools.product([2, 3], [1, 2, 3, 7], [6, 8, 10])))
def test_hls_lut_equal(a, n, p, mode):
    got, want = weights.hls_lut(a, n, p, mode), tpu_weights.hls_lut(a, n, p, mode)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize(
    "in_size,out_size,a,p",
    [(20, 40, 2, 8), (20, 60, 3, 8), (20, 30, 2, 8), (24, 36, 3, 6), (5, 10, 2, 10),
     (2, 8, 3, 8), (40, 100, 2, 10)],
)
def test_hls_schedule_and_fixed_weights_equal(in_size, out_size, a, p):
    got = weights.hls_schedule(in_size, out_size, a, p)
    want = tpu_weights.hls_schedule(in_size, out_size, a, p)
    for f in ("in_size", "out_size", "a", "lut_overflow"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("eff_idx", "valid", "lut_idx"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    op = weights.banded_weights(in_size, out_size, a)
    op_tpu = tpu_weights.banded_weights(in_size, out_size, a)
    assert np.array_equal(weights.fixed_point_weights(op, p),
                          tpu_weights.fixed_point_weights(op_tpu, p))


def test_hls_schedule_refuses_downscale():
    with pytest.raises(ValueError, match="upscale-only"):
        weights.hls_schedule(40, 20, 2, 8)


@pytest.mark.parametrize("in_size,out_size,a", [(20, 40, 2), (20, 60, 3), (24, 36, 3),
                                                (7, 11, 2), (3, 12, 3)])
def test_oracle_weights_equal(in_size, out_size, a):
    from lanczos_tpu.ref import oracle as tpu_oracle

    from lanczos_torch.ref import oracle

    got = oracle._oracle_weights(out_size, in_size, a)
    want = tpu_oracle._oracle_weights(out_size, in_size, a)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(scale=(2, 1)), dict(scale=(3, 2), edge_mode="reflect", align="center"),
    dict(scale=(1, 2), edge_mode="drop", normalize=False),
    dict(scale=(3, 2), intermediate_quantize=True, order="width_first"),
])
def test_clean_resample_2d_equal(kw):
    from lanczos_tpu.ref import oracle as tpu_oracle

    from lanczos_torch.ref import oracle

    img = np.random.default_rng(0).integers(0, 256, (16, 20, 3), dtype=np.uint8)
    got = oracle.clean_resample_2d(img, config.ResampleConfig.from_profile(
        "precise", (16, 20), a=3, **kw))
    want = tpu_oracle.clean_resample_2d(img, tpu_config.ResampleConfig.from_profile(
        "precise", (16, 20), a=3, **kw))
    assert got.dtype == want.dtype and np.array_equal(got, want)
