"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on a machine with a card (the
JAX package's ``tests/conftest.py`` needs JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Limits: the fused kernel (every instantiation) fp32 ≤ 1 LSB on ≤ 1% of
pixels, bf16 ≤ 3 LSB on ≤ 50% (the same plan and rounding points: only
the order of the fp32 sums differs); kernel 2 and the v1 kernel
identical bytes (the same multiply-then-add sequence in the same order);
each ablation kernel identical bytes to its plain version, and to the
production kernel where it keeps its semantics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.ops import resample_phase_cuda as rp  # noqa: E402
from lanczos_torch.ops import resample_shift_cuda as rs  # noqa: E402
from lanczos_torch.tools import ablate_fused as af  # noqa: E402

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


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw,planes", [
    ((60, 80), (2, 1), {"dering": True}, 3),
    ((60, 80), (3, 1), {"dering": True, "edge_mode": "reflect"}, 3),
    ((60, 80), (3, 2), {"dering": True}, 3),
    ((48, 64), (3, 2), {"dering": True, "edge_mode": "drop", "normalize": False}, 3),
    ((48, 64), (3, 2), {"dering": True, "edge_mode": "drop"}, 3),
    ((48, 64), (2, 1), {"intermediate_quantize": True}, 3),
    ((48, 64), (2, 1), {"dering": True, "intermediate_quantize": True}, 3),
    ((100, 300), (2, 1), {"dering": True}, 6),  # ragged tile and block, a batch of 2
])
def test_nonlinear_kernel_matches_plain_version(cuda, shape, scale, kw, planes, precision):
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    ops = rc.FusedOps(cfg, cuda)
    assert ops.variant == "mxu" and ops.kernel.startswith(f"fused_resample_{precision}_")
    x = np.random.default_rng(2).integers(0, 256, (planes,) + shape, dtype=np.uint8)
    x = torch.from_numpy(x).to(cuda)
    before = rc.launches[ops.kernel]
    got = rc.fused_call(ops, x)
    torch.cuda.synchronize()
    assert rc.launches[ops.kernel] == before + 1
    want = rc.fused_resample_reference(
        x, ops.plan, precision, cfg.out_shape, cfg.dering, cfg.intermediate_quantize
    )
    _within(got, want, precision)


def test_width_first_dering_runs_the_transposed_kernel(cuda):
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", (40, 56), scale=(3, 2), a=3, dering=True, order="width_first"
    )
    ops = rc.FusedOps(cfg, cuda)
    assert ops.tr_ops is not None and ops.kernel == "fused_resample_fp32_dering"
    x = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 3, 40, 56), dtype=np.uint8)
    ).to(cuda)
    before = rc.launches[ops.kernel]
    got = rc.upscale_planar(x, ops)
    torch.cuda.synchronize()
    assert rc.launches[ops.kernel] == before + 1
    assert got.shape == (2, 3, 60, 84)
    want = rc.upscale_planar(x.cpu(), rc.FusedOps(cfg, "cpu"))
    _within(got.cpu(), want, "fp32")


@pytest.mark.parametrize("dering", [True, False])
@pytest.mark.parametrize("shape,scale,kw", [
    ((24, 40), (2, 1), {}),
    ((24, 40), (3, 1), {}),
    ((24, 40), (2, 1), {"align": "center"}),
    ((24, 40), (2, 1), {"edge_mode": "reflect"}),
    ((37, 150), (4, 1), {"align": "center", "edge_mode": "reflect"}),  # ragged tiles
    ((20, 30), (16, 1), {}),  # the most phases v2 takes
])
def test_shift_kernel_equals_plain_version(cuda, shape, scale, kw, dering):
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, dering=dering, **kw
    )
    ops = rc.FusedOps(cfg, cuda, variant="v2")
    assert ops.kernel == "shift_resample"
    x = np.random.default_rng(4).integers(0, 256, (6,) + shape, dtype=np.uint8)
    x = torch.from_numpy(x).to(cuda)
    before = rs.launches["shift_resample"]
    got = rc.upscale_planar(x, ops)
    torch.cuda.synchronize()
    assert rs.launches["shift_resample"] == before + 1
    want = rs.shift_resample_reference(x, ops.shift.plan, cfg.out_shape, dering)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), rs.shift_resample_reference(x.cpu(), ops.shift.plan,
                                                               cfg.out_shape, dering))


def test_upscale_dering_runs_on_the_kernel(cuda):
    img = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    ).to(cuda)
    for kw, kernel in [
        ({"dering": True}, "fused_resample_fp32_dering"),
        ({"intermediate_quantize": True, "precision": "bf16"}, "fused_resample_bf16_quant"),
    ]:
        before = rc.launches[kernel]
        y = lanczos_torch.upscale(img, scale=(2, 1), **kw)
        assert y.is_cuda and y.shape == (96, 160, 3)
        assert rc.launches[kernel] == before + 1
        want = lanczos_torch.upscale(img.cpu(), scale=(2, 1), **kw)
        _within(y.cpu(), want, kw.get("precision", "fp32"))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,kw", [
    ((24, 40), (36, 60), {}),  # 3/2
    ((36, 60), (24, 40), {"align": "center"}),  # 2/3
    ((256, 256), (16, 16), {}),  # 1/16, support 48
    ((384, 384), (24, 24), {}),  # 1/16 with no fused plan: the tile shrinks, ragged rows
    ((24, 40), (48, 60), {"edge_mode": "reflect"}),  # 2/1 by 3/2
    ((25, 41), (37, 61), {}),  # ragged, 37 and 61 phases
    ((32, 48), (2, 3), {"edge_mode": "reflect"}),  # support 48 > the image
    ((24, 40), (36, 40), {"edge_mode": "drop", "normalize": False}),  # 3/2 by 1/1
])
def test_phase_kernel_equals_plain_version(cuda, shape, out, kw, precision):
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, out_shape=out, a=3, precision=precision, **kw
    )
    ops = rc.FusedOps(cfg, cuda, variant="v1")
    assert ops.variant == "v1" and ops.kernel.startswith("phase_resample_")
    x = np.random.default_rng(6).integers(0, 256, (6,) + shape, dtype=np.uint8)
    x = torch.from_numpy(x).to(cuda)
    before = rp.launches[ops.kernel]
    got = rc.upscale_planar(x, ops)
    torch.cuda.synchronize()
    assert rp.launches[ops.kernel] == before + 1
    want = rp.phase_resample_reference(x, ops.phase.plan, precision, out)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), rp.phase_resample_reference(x.cpu(), ops.phase.plan,
                                                              precision, out))


def test_upscale_pallas_backend_runs_v1(cuda):
    img = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (384, 384, 3), dtype=np.uint8)
    ).to(cuda)
    before = rp.launches["phase_resample_fp32"]
    y = lanczos_torch.upscale(img, out_shape=(24, 24), backend="pallas")
    assert y.is_cuda and y.shape == (24, 24, 3)
    assert rp.launches["phase_resample_fp32"] == before + 1
    want = lanczos_torch.upscale(img.cpu(), out_shape=(24, 24), backend="pallas")
    assert torch.equal(y.cpu(), want)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("stage", af.STAGES)
@pytest.mark.parametrize("in_shape,out_shape,tile,cb", [
    ((36, 64), (72, 128), 16, 32),  # ragged rows; 16-byte aligned output rows
    ((50, 92), (100, 184), 8, 32),  # ragged rows and blocks, unaligned rows, odd starts
])
def test_ablation_kernel_equals_plain_version(cuda, in_shape, out_shape, tile, cb, stage,
                                              precision):
    cfg = af.frame_cfg(af.Precision(precision), in_shape, out_shape)
    ops = rc.FusedOps(cfg, cuda, rc.plan_at(cfg, tile, cb))
    x = np.random.default_rng(8).integers(0, 256, (6,) + in_shape, dtype=np.uint8)
    x = torch.from_numpy(x).to(cuda)
    name = "ablate_fused_" + ("f32" if precision == "fp32" else "") + stage
    before = af.launches[name]
    got = af.ablate_call(ops, x, stage)
    torch.cuda.synchronize()
    assert af.launches[name] == before + 1
    want = af.ablation_reference(x, ops.plan, cfg.precision, stage, out_shape)
    assert torch.equal(got, want)
    if stage not in af.DIFFERS:
        assert torch.equal(got, rc.fused_call(ops, x))
