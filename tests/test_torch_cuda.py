"""The CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Limits: fp32 ≤ 1 LSB on ≤ 1% of pixels, bf16 ≤ 3 LSB on ≤ 50% (the same
plan and rounding points: only the order of the fp32 sums differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402

pytestmark = pytest.mark.cuda
LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within(got, want, precision):
    d = (got.int() - want.int()).abs()
    lim, frac_lim = LIMITS[precision]
    assert int(d.max()) <= lim
    assert float((d > 0).float().mean()) <= frac_lim


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw,planes", [
    ((100, 300), (2, 1), {}, 3),  # ragged row tile and column block
    ((96, 160), (3, 2), {}, 3),
    ((90, 130), (2, 1), {"align": "center"}, 3),
    ((64, 96), (2, 1), {}, 6),  # a batch of two planar images
    ((128, 512), (1, 2), {}, 3),  # over 48 KB of shared memory
])
def test_kernel_matches_plain_version(cuda, shape, scale, kw, planes, precision):
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    ops = rc.FusedOps(cfg, cuda)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (planes,) + shape, dtype=np.uint8)
    x = torch.from_numpy(x).to(cuda)
    before = rc.launches[ops.kernel]
    got = rc.fused_call(ops, x)
    torch.cuda.synchronize()
    assert rc.launches[ops.kernel] == before + 1
    want = rc.fused_resample_reference(x, ops.plan, precision, cfg.out_shape)
    _within(got, want, precision)


def test_upscale_runs_on_the_kernel(cuda):
    img = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    ).to(cuda)
    before = rc.launches["fused_resample_fp32"]
    y = lanczos_torch.upscale(img, scale=(2, 1))
    assert y.is_cuda and y.shape == (2, 96, 160, 3)
    assert rc.launches["fused_resample_fp32"] == before + 1
    want = lanczos_torch.upscale(img.cpu(), scale=(2, 1))
    _within(y.cpu(), want, "fp32")


def test_wrapper_refuses_bad_inputs(cuda):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (16, 24), scale=(2, 1))
    ops = rc.FusedOps(cfg, cuda)
    x = torch.zeros((3, 16, 24), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rc.fused_call(ops, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="expected"):
        rc.fused_call(ops, x.to(torch.int8))
    with pytest.raises(ValueError, match="weights on"):
        rc.fused_call(ops, x.cpu())
