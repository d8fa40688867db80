"""The ``box`` filter (``core/filters.py``: weight 1 where |t| ≤ 0.5, the
area average users make thumbnails with) on every path of the port,
against the JAX gather on the same seeded numpy inputs.

6 scales × a ∈ {2, 3} × 3 edge modes, each case over both alignments with
dering off and on: the port's ``xla``, ``shift_xla``, ``pallas`` and
``auto`` within 1 LSB of the JAX ``xla`` (a backend that refuses a config
is skipped, as ``tests/test_fuzz.py`` skips; ``xla`` and ``auto`` never
refuse), and the fused kernel's plain version identical bytes to the port
``auto`` where it takes the config.  Box keeps one or two taps an output
(two at a tie, |t| = 0.5 exactly), so these configs reach the plan code
with runs far shorter than the band.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as JaxConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as JaxUpscaler  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402

SCALES = [(2, 1), (3, 1), (3, 2), (1, 2), (2, 3), (1, 4)]
BACKENDS = ("xla", "shift_xla", "pallas", "auto")


@pytest.mark.parametrize("edge", ["clamp", "drop", "reflect"])
@pytest.mark.parametrize("a", [2, 3])
@pytest.mark.parametrize("scale", SCALES, ids=[f"{n}_{d}" for n, d in SCALES])
def test_box_on_every_path(scale, a, edge):
    n, d = scale
    shape = (6 * d, 8 * d)
    img = np.random.default_rng(100 * n + 10 * d + a).integers(
        0, 256, size=(*shape, 3), dtype=np.uint8)
    for align in ("zero", "center"):
        for dering in (False, True):
            kw = dict(scale=scale, a=a, filter="box", edge_mode=edge, align=align,
                      dering=dering, normalize=edge != "drop")
            cfg = lanczos_torch.ResampleConfig.from_profile("precise", shape, **kw)
            ref = np.asarray(JaxUpscaler(JaxConfig.from_profile("precise", shape, **kw),
                                         backend="xla")(img)).astype(int)
            outs = {}
            for b in BACKENDS:
                try:
                    outs[b] = lanczos_torch.Upscaler(cfg, backend=b, device="cpu")(img).numpy()
                except (NotImplementedError, ValueError):
                    assert b not in ("xla", "auto"), (b, kw)
                    continue
                assert outs[b].shape == ref.shape, (b, kw)
                assert np.abs(outs[b].astype(int) - ref).max() <= 1, (b, kw)
            try:
                fused = rc.FusedOps(cfg, "cpu", variant="mxu")
            except NotImplementedError:
                continue
            got = rc.resample_2d_cuda(torch.from_numpy(img), fused).numpy()
            if lanczos_torch.Upscaler(cfg, backend="auto", device="cpu").path == "cuda":
                np.testing.assert_array_equal(got, outs["auto"], err_msg=str(kw))
            assert np.abs(got.astype(int) - ref).max() <= 1, kw
