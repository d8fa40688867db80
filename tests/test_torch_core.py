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
