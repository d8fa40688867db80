"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on a machine with a card (the
JAX package's ``tests/conftest.py`` needs JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Limits: the fused kernel (every instantiation, on its own plans and on
hand-built chunk plans), kernel 2 and the v1 kernels (every design, and
the generic design forced) identical bytes to their plain versions (the
same taps in the same order, each rounded once: ``fmaf`` on the card,
``ops._fma.fma_sum`` in the plain versions), constant planes and the
non-Lanczos filters included; each ablation
kernel identical bytes to its dense plain version, and within the fused
kernel's limits of the production kernel where it keeps its semantics
(a dense product sums in another order than the band-sparse kernel).  The tensor-op paths: the
bit-exact profiles identical bytes on CUDA and on the CPU (integer
arithmetic); the gather, strided and block paths on CUDA against the CPU
under the same limits (float output |Δ| ≤ 1e-3), block identical with
TF32 allowed (it contracts fp32 in float64).  Streaming: the fused kernel
on hand-built chunk plans under the fused kernel's limits against its
plain version on the same plan; pipelined, resumed and earlier-yielded
chunks identical bytes to a serial run's; the streamed peak of device
memory within twice what ``depth``, the window and the chunk predict.
Sharding: the fused kernel on every shard's own vertical tables (``wv=``)
identical bytes to the whole-frame kernel, kernel against kernel, and the
sharded stream and video identical to their unsharded runs.
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
    ((50, 77), (2, 1), {}, 3),  # odd W and OW = 154: the byte paths in and out
    ((45, 96), (3, 1), {}, 3),  # W % 16 == 0, OW = 288, block starts off 16-byte bounds
    ((40, 120), (3, 2), {}, 3),  # OW = 180: 16-byte loads, byte stores
    ((12, 16), (2, 1), {}, 3),  # one tile, one block
    ((64, 256), (2, 1), {}, 1),  # every path 16-byte aligned, 4 column blocks
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
    assert torch.equal(got, want)  # each tap one fmaf in both


def test_upscale_runs_on_the_kernel(cuda):
    img = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    ).to(cuda)
    before = rc.launches["fused_resample_fp32"]
    y = lanczos_torch.upscale(img, scale=(2, 1))
    assert y.is_cuda and y.shape == (2, 96, 160, 3)
    assert rc.launches["fused_resample_fp32"] == before + 1
    want = lanczos_torch.upscale(img.cpu(), scale=(2, 1))
    assert torch.equal(y.cpu(), want)  # the kernel and the plain version on the CPU


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
    ((50, 77), (2, 1), {"dering": True}, 3),  # odd W, OW = 154
    ((40, 120), (3, 2), {"dering": True, "intermediate_quantize": True}, 3),  # OW = 180
    ((12, 16), (2, 1), {"dering": True}, 3),  # one tile, one block
    ((64, 256), (2, 1), {"dering": True, "intermediate_quantize": True}, 1),  # all aligned
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
    assert torch.equal(got, want)  # each tap one fmaf in both


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw,tiles", [
    ((96, 600), (3, 2), {}, (16, 384)),  # a wide block: 24 staged chunks a row
    ((38, 54), (3, 2), {"dering": True}, (8, 20)),  # one row group, 5 column groups
    ((24, 40), (1, 2), {}, (8, 16)),  # a downscale's long windows
    ((40, 64), (2, 1), {"intermediate_quantize": True}, (13, 20)),  # tile_p padding
])
def test_kernel_on_hand_picked_tiles_matches_plain_version(cuda, shape, scale, kw, tiles,
                                                           precision):
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=3, precision=precision, **kw
    )
    plan = rc.plan_at(cfg, *tiles)
    ops = rc.FusedOps(cfg, cuda, plan)
    x = np.random.default_rng(12).integers(0, 256, (3,) + shape, dtype=np.uint8)
    x = torch.from_numpy(x).to(cuda)
    before = rc.launches[ops.kernel]
    got = rc.fused_call(ops, x)
    torch.cuda.synchronize()
    assert rc.launches[ops.kernel] == before + 1
    want = rc.fused_resample_reference(
        x, plan, precision, cfg.out_shape, cfg.dering, cfg.intermediate_quantize
    )
    assert torch.equal(got, want)  # each tap one fmaf in both


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
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dering", [True, False])
@pytest.mark.parametrize("shape,scale,kw", [
    ((24, 40), (2, 1), {}),
    ((24, 40), (3, 1), {}),
    ((24, 40), (2, 1), {"align": "center"}),
    ((24, 40), (2, 1), {"edge_mode": "reflect"}),
    ((37, 150), (4, 1), {"align": "center", "edge_mode": "reflect"}),  # ragged tiles
    ((20, 30), (16, 1), {}),  # the most phases v2 takes
    ((40, 64), (4, 1), {}),  # W % 16 == 0: copied 16-byte chunks
    ((70, 160), (3, 1), {"edge_mode": "reflect"}),  # copied and mapped chunks, 4 row tiles
    ((64, 256), (2, 1), {}),  # the main path's phases, 4 column chunks
    ((33, 47), (5, 1), {}),  # a phase count with no 16-byte output rows
    ((30, 48), (2, 1), {"a": 2}),  # the support-2 instantiation
    ((30, 48), (3, 1), {"a": 4}),  # the generic instantiation
    ((21, 19), (2, 1), {"a": 5, "edge_mode": "reflect"}),  # generic, support 5
])
def test_shift_kernel_equals_plain_version(cuda, shape, scale, kw, dering):
    kw = dict(kw)
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, scale=scale, a=kw.pop("a", 3), dering=dering, **kw
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
        assert torch.equal(y.cpu(), want)


V1_CASES = [  # (in, out, overrides): every design and instantiation of the v1 source
    ((24, 40), (36, 60), {}),  # 3/2
    ((36, 60), (24, 40), {"align": "center"}),  # 2/3
    ((256, 256), (16, 16), {}),  # 1/16, support 48
    ((384, 384), (24, 24), {}),  # 1/16 with no fused plan: ragged chunks of rows
    ((24, 40), (48, 60), {"edge_mode": "reflect"}),  # 2/1 by 3/2
    ((25, 41), (37, 61), {}),  # ragged, 37 and 61 phases
    ((32, 48), (2, 3), {"edge_mode": "reflect"}),  # support 48 > the image
    ((24, 40), (36, 40), {"edge_mode": "drop", "normalize": False}),  # 3/2 by 1/1
    # the window design: each compile-time pair, 16-byte and byte paths, ragged blocks
    ((96, 160), (144, 240), {}),  # 3/2, W % 16 == 0, 3 x 3 blocks
    ((81, 144), (108, 192), {}),  # 4/3
    ((70, 96), (70, 128), {}),  # the desqueeze: 1/1 by 4/3
    ((81, 100), (108, 100), {}),  # 4/3 by 1/1, W % 16 != 0
    ((50, 64), (50, 96), {"edge_mode": "reflect"}),  # 1/1 by 3/2
    ((40, 70), (60, 140), {}),  # 3/2 by 2/1
    ((90, 120), (135, 180), {"align": "center"}),  # center: the run-time form
    ((48, 80), (60, 100), {}),  # 5/4
    ((48, 80), (72, 120), {"a": 2}),  # 3/2 at support 2
    ((34, 46), (51, 69), {"a": 4, "edge_mode": "drop", "normalize": False}),  # 8 taps
    ((60, 90), (90, 120), {}),  # 3/2 by 4/3: no compile-time pair
    # the streamed design: live rows 4, 6, 8; edges; the byte path; ragged stripes
    ((512, 208), (128, 52), {}),  # 1/4: the second stripe is 80 columns
    ((128, 50), (32, 25), {}),  # W % 16 != 0
    ((128, 64), (16, 16), {"edge_mode": "drop", "normalize": False}),  # zero edges
    ((128, 64), (32, 16), {"align": "center"}),
    ((128, 48), (16, 72), {"a": 2}),  # 4 live rows; 1/8 by 3/2
    ((160, 32), (32, 32), {"a": 4}),  # 8 live rows; 1/5 by 1/1
    ((640, 700), (40, 700), {"edge_mode": "reflect"}),  # 1/16 by 1/1, six stripes
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("design", ["auto", "generic"])
@pytest.mark.parametrize("shape,out,kw", V1_CASES)
def test_phase_kernel_equals_plain_version(cuda, shape, out, kw, design, precision):
    kw = dict(kw)
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, out_shape=out, a=kw.pop("a", 3), precision=precision, **kw
    )
    ops = rc.FusedOps(cfg, cuda, variant="v1", design=design)
    assert ops.variant == "v1" and ops.kernel.startswith("phase_resample_")
    assert design == "auto" or ops.phase.design == "generic"
    x = np.random.default_rng(6).integers(0, 256, (6,) + shape, dtype=np.uint8)
    x = torch.from_numpy(x).to(cuda)
    before = dict(rp.launches)
    got = rc.upscale_planar(x, ops)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in rp.launches.items() if n != before[k]} == {
        k: 1 for k in ops.phase.kernels}
    want = rp.phase_resample_reference(x, ops.phase.plan, precision, out)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), rp.phase_resample_reference(x.cpu(), ops.phase.plan,
                                                              precision, out))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("rpc", [None, 1, 5, 1000])
def test_stream_kernels_equal_their_plain_versions(cuda, rpc, precision):
    """The streamed design's two kernels, each against its own plain
    version, at any chunking of the rows."""
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", (384, 400), out_shape=(24, 25), a=3, precision=precision)
    ops = rp.PhaseOps(cfg, cuda)
    assert ops.design == "stream"
    x = torch.from_numpy(
        np.random.default_rng(12).integers(0, 256, (3, 384, 400), dtype=np.uint8)).to(cuda)
    mid = rp.stream_v_call(ops, x, rpc=rpc)
    want_mid = rp.stream_v_reference(x, ops.plan, precision, 24)
    assert mid.dtype == want_mid.dtype and torch.equal(mid, want_mid)
    out = rp.stream_h_call(ops, mid)
    torch.cuda.synchronize()
    assert torch.equal(out, rp.stream_h_reference(want_mid, ops.plan, precision, 25))
    assert torch.equal(out, rp.phase_resample_reference(x, ops.plan, precision, (24, 25)))


def test_upscale_pallas_backend_runs_v1(cuda):
    """A 1/16 thumbnail of a 640×800 frame: no fused plan fits (a 16-row
    tile's band outgrows shared memory), so ``backend="pallas"`` runs v1:
    its streamed design's two kernels."""
    img = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (640, 800, 3), dtype=np.uint8)
    ).to(cuda)
    before = dict(rp.launches)
    y = lanczos_torch.upscale(img, out_shape=(40, 50), backend="pallas")
    assert y.is_cuda and y.shape == (40, 50, 3)
    assert {k: n - before[k] for k, n in rp.launches.items() if n != before[k]} == {
        "phase_stream_v_fp32": 1, "phase_stream_h_fp32": 1}
    want = lanczos_torch.upscale(img.cpu(), out_shape=(40, 50), backend="pallas")
    assert torch.equal(y.cpu(), want)


def test_small_thumbnail_now_has_a_fused_plan(cuda):
    """A 1/16 thumbnail of a 384×384 frame fits the fused kernel's uint8
    band (143-step windows), so ``backend="pallas"`` takes it there."""
    img = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (384, 384, 3), dtype=np.uint8)
    ).to(cuda)
    before = rc.launches["fused_resample_fp32"]
    y = lanczos_torch.upscale(img, out_shape=(24, 24), backend="pallas")
    assert y.is_cuda and y.shape == (24, 24, 3)
    assert rc.launches["fused_resample_fp32"] == before + 1
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
        _within(got, rc.fused_call(ops, x), precision)


@pytest.mark.parametrize("profile,shape,scale,kw", [
    ("hls", (48, 40), (2, 1), {"a": 2}),
    ("hls", (40, 56), (3, 2), {"a": 2, "bit_precision": 10}),
    ("hls", (24, 32), (3, 1), {"a": 3, "bit_precision": 6}),
    ("c_oracle", (48, 40), (2, 1), {"a": 3}),
    ("c_oracle", (36, 44), (3, 2), {"a": 2}),
    ("c_oracle", (44, 40), (5, 4), {"a": 3}),
])
def test_bit_exact_profiles_cuda_equal_cpu(cuda, profile, shape, scale, kw):
    img = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2,) + shape + (3,), dtype=np.uint8))
    y = lanczos_torch.upscale(img.to(cuda), scale=scale, profile=profile, **kw)
    assert y.is_cuda and y.dtype == torch.uint8
    assert torch.equal(y.cpu(), lanczos_torch.upscale(img, scale=scale, profile=profile, **kw))


@pytest.mark.parametrize("backend", ["xla", "shift_xla", "block"])
@pytest.mark.parametrize("precision,kw,dtype", [
    ("fp32", {}, np.uint8),
    ("fp32", {"dering": True, "edge_mode": "reflect", "align": "center"}, np.uint8),
    ("bf16", {}, np.uint8),
    ("fp32", {}, np.float32),
    ("fp32", {}, np.uint16),
])
def test_float_paths_cuda_vs_cpu(cuda, backend, precision, kw, dtype):
    rng = np.random.default_rng(10)
    shape = (36, 60)
    img = (rng.random(shape + (3,), dtype=np.float32) * 255 if dtype == np.float32
           else rng.integers(0, np.iinfo(dtype).max + 1, shape + (3,), dtype=dtype))
    x = torch.from_numpy(img)
    args = dict(scale=(3, 2), backend=backend, precision=precision, **kw)
    y = lanczos_torch.upscale(x.to(cuda), **args)
    want = lanczos_torch.upscale(x, **args)
    assert y.is_cuda and y.dtype == want.dtype
    if dtype == np.float32:
        assert float((y.cpu() - want).abs().max()) <= 1e-3
    else:
        _within(y.cpu(), want, precision)


def test_block_ignores_tf32(cuda):
    """The block path's fp32 products stay exact with TF32 allowed globally."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (108, 192), out_shape=(113, 200))
    up = lanczos_torch.Upscaler(cfg, backend="block", device=cuda)
    x = torch.from_numpy(np.random.default_rng(11).random((108, 192, 3), dtype=np.float32)
                         * 255).to(cuda)
    exact = up(x)
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = up(x)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(tf32, exact)


CHUNK_FAMILIES = [  # the reference's seven fused-chunk families: out, overrides, chunk
    ((192, 128), {}, 32),
    ((144, 96), {}, 24),
    ((48, 32), {}, 16),
    ((192, 128), {"edge_mode": "reflect"}, 32),
    ((192, 128), {"dering": True}, 32),
    ((192, 128), {"intermediate_quantize": True}, 32),
    ((192, 128), {"align": "center"}, 32),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("outs,kw,chunk", CHUNK_FAMILIES)
def test_chunk_plan_kernel_matches_plain_version(cuda, outs, kw, chunk, precision):
    """``fused_call`` on a hand-built chunk plan (a window-rebased operator
    and a shifted offset), and the streamed frame kernel against kernel."""
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", (96, 64), out_shape=outs, a=3, precision=precision, **kw)
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=chunk, chunk_backend="mxu")
    assert sm.chunk_path == "fused" and sm.device.type == "cuda"
    ops = sm._mxu
    x = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (3, sm.win, 64), dtype=np.uint8)).to(cuda)
    before = rc.launches[ops.kernel]
    got = rc.fused_call(ops, x)
    torch.cuda.synchronize()
    assert rc.launches[ops.kernel] == before + 1
    want = rc.fused_resample_reference(x, ops.plan, precision, ops.cfg.out_shape,
                                       cfg.dering, cfg.intermediate_quantize)
    assert torch.equal(got, want)
    img = np.random.default_rng(14).integers(0, 256, (96, 64, 3), dtype=np.uint8)
    before = rc.launches[ops.kernel]
    out = sm(img)
    assert rc.launches[ops.kernel] == before + sm.n_chunks
    whole = lanczos_torch.Upscaler(cfg)(torch.from_numpy(img).to(cuda)).cpu().numpy()
    assert np.abs(out.astype(int) - whole.astype(int)).max() <= (
        1 if precision == "fp32" else 3)


@pytest.mark.parametrize("backend", ["mxu", "shift", "gather"])
def test_streaming_pipelined_equals_serial_under_a_sleeping_source(cuda, backend):
    """Staging buffers and device blocks are reused under skew: a source
    that sleeps at random, depth 3 with the prefetch thread, against a
    serial run; a resumed run against the tail; earlier chunks stay valid."""
    import time

    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (600, 256), scale=(2, 1), a=3)
    img = np.random.default_rng(15).integers(0, 256, (600, 256, 3), dtype=np.uint8)
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=64, chunk_backend=backend)
    naps = np.random.default_rng(16).random(64) * 0.004

    def sleepy(lo, hi):
        time.sleep(naps[lo % 64])
        return img[lo:hi]

    serial = list(sm.chunks(lambda lo, hi: img[lo:hi], depth=1, prefetch=False))
    held = []
    for y0, rows in sm.chunks(sleepy, depth=3, prefetch=True):
        held.append((y0, rows, rows.copy()))
    assert [y for y, _ in serial] == [y for y, _, _ in held]
    for (_, a), (_, b, b_then) in zip(serial, held):
        assert np.array_equal(a, b_then)
        assert np.array_equal(b, b_then)  # not written again by a later chunk
    resumed = list(sm.chunks(sleepy, start_chunk=5, depth=2))
    assert [y for y, _ in resumed] == [y for y, _ in serial[5:]]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(serial[5:], resumed))
    want = lanczos_torch.Upscaler(cfg, backend="xla")(torch.from_numpy(img).to(cuda))
    got = np.concatenate([a for _, a in serial])
    assert np.abs(got.astype(int) - want.cpu().numpy().astype(int)).max() <= (backend == "mxu")


def test_streaming_source_error_surfaces_and_the_device_stays_usable(cuda):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (600, 256), scale=(2, 1), a=3)
    img = np.random.default_rng(17).integers(0, 256, (600, 256, 3), dtype=np.uint8)
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=64)

    def dies(lo, hi):
        if lo > 300:
            raise OSError("decoder died")
        return img[lo:hi]

    with pytest.raises(OSError, match="decoder died"):
        list(sm.chunks(dies, depth=3))
    gen = sm.chunks(lambda lo, hi: img[lo:hi], depth=3)
    next(gen)
    gen.close()  # abandoned with chunks in flight
    whole = lanczos_torch.Upscaler(cfg)(torch.from_numpy(img).to(cuda)).cpu().numpy()
    assert np.abs(sm(img).astype(int) - whole.astype(int)).max() <= 1


def test_streamed_peak_memory_is_bounded_by_the_chunk(cuda):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (4096, 1024), scale=(2, 1), a=3)
    img = np.random.default_rng(18).integers(0, 256, (4096, 1024, 3), dtype=np.uint8)
    sm = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=256, chunk_backend="mxu")
    sm(img)  # tables uploaded, staging buffers cached
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sm(img)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    per_chunk = 3 * (sm.win * 1024 + sm.chunk * 2048)  # a window and a chunk of rows
    assert per_chunk * 3 <= peak <= 2 * per_chunk * (3 + 1)  # depth 3, one chunk's temporaries
    assert out.shape == (8192, 2048, 3)
    assert peak < (img.nbytes + out.nbytes) / 3


def test_video_and_y4m_equal_the_upscaler(cuda, tmp_path):
    from lanczos_torch.io import y4m

    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (120, 160), scale=(2, 1), a=3)
    video = np.random.default_rng(19).integers(0, 256, (7, 120, 160, 3), dtype=np.uint8)
    single = lanczos_torch.Upscaler(cfg)
    want = [single(torch.from_numpy(f).to(cuda)).cpu().numpy() for f in video]
    vu = lanczos_torch.VideoUpscaler(cfg, batch=3, depth=2)
    buf = np.empty_like(video[0])

    def producer():
        for f in video:
            buf[...] = f
            yield buf

    before = rc.launches["fused_resample_fp32"]
    outs = list(vu.frames(producer()))
    assert rc.launches["fused_resample_fp32"] == before + 3
    assert len(outs) == 7 and all(np.array_equal(a, b) for a, b in zip(outs, want))
    assert np.array_equal(vu(video), np.stack(want))
    rng = np.random.default_rng(20)
    frames = [(rng.integers(0, 256, (48, 64), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8),
               rng.integers(0, 256, (24, 32), dtype=np.uint8)) for _ in range(5)]
    y4m.write_y4m(str(tmp_path / "in.y4m"), frames, fps=(24, 1))
    hdr = lanczos_torch.upscale_y4m(str(tmp_path / "in.y4m"), str(tmp_path / "out.y4m"),
                                    scale=(2, 1), batch=2)
    assert (hdr.width, hdr.height, hdr.fps) == (128, 96, (24, 1))
    _, got = y4m.read_y4m(str(tmp_path / "out.y4m"))
    assert len(got) == 5
    for f_in, f_out in zip(frames, got):
        for p_in, p_out in zip(f_in, f_out):
            up = lanczos_torch.Upscaler(lanczos_torch.ResampleConfig.from_profile(
                "precise", p_in.shape, scale=(2, 1), a=3))
            want_p = up.planar(torch.from_numpy(p_in[None]).to(cuda))[0].cpu().numpy()
            assert np.array_equal(p_out, want_p)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,kw,mesh_shape", [
    ((64, 48), {}, (2, 4)),
    ((96, 160), {"dering": True}, (1, 4)),
    ((120, 96), {"intermediate_quantize": True}, (2, 2)),
    ((48, 64), {"dering": True, "edge_mode": "drop", "normalize": False}, (1, 4)),
    ((90, 120), {"align": "center"}, (1, 3)),
])
def test_sharded_fused_kernel_equals_the_whole_frame_kernel(cuda, shape, kw, mesh_shape,
                                                            precision):
    from lanczos_torch.parallel.mesh import Mesh

    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", shape, scale=(2, 1), a=3, precision=precision, **kw)
    d_n, r_n = mesh_shape
    mesh = Mesh.local([cuda] * (d_n * r_n), mesh_shape)
    img = torch.from_numpy(np.random.default_rng(21).integers(
        0, 256, (2 * d_n,) + shape + (3,), dtype=np.uint8)).to(cuda)
    single = lanczos_torch.Upscaler(cfg)
    want = single(img)
    for overlap, per_shard in ((True, 2), (False, 1)):
        sh = lanczos_torch.ShardedUpscaler(cfg, mesh, backend="mxu", overlap=overlap)
        kernel = sh._tables(img.device).fused.kernel
        before = rc.launches[kernel]
        got = sh(img)
        torch.cuda.synchronize()
        assert rc.launches[kernel] == before + per_shard * d_n * r_n
        assert got.is_cuda and torch.equal(got, want)


def test_wv_tables_refusals_on_the_card(cuda):
    import dataclasses

    from lanczos_torch.parallel.mesh import Mesh

    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (64, 48), scale=(2, 1), a=3)
    sh = lanczos_torch.ShardedUpscaler(cfg, Mesh.local([cuda] * 4, (1, 4)), backend="mxu")
    t = sh._tables(cuda)
    x = torch.zeros((3, 16 + 2 * sh.halo, 48), dtype=torch.uint8, device=cuda)
    assert rc.fused_call(t.fused, x, wv=t.wv[2]).shape == (3, 32, 96)
    p = sh._plans[2]
    with pytest.raises(ValueError, match="have win_v="):
        rc.fused_call(t.fused, x, wv=rc.vertical_tables(
            dataclasses.replace(p, win_v=p.win_v + 1), cfg.precision, cuda))
    with pytest.raises(ValueError, match="device tensors"):
        rc.fused_call(t.fused, x, wv=rc.vertical_tables(p, cfg.precision, "cpu"))
    with pytest.raises(ValueError, match="bf16"):
        rc.fused_call(t.fused, x, wv=rc.vertical_tables(p, lanczos_torch.Precision.BF16, cuda))


def test_sharded_stream_and_video_on_the_card(cuda):
    from lanczos_torch.parallel.mesh import Mesh

    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (400, 96), scale=(2, 1), a=3)
    img = np.random.default_rng(22).integers(0, 256, (400, 96, 3), dtype=np.uint8)
    base = lanczos_torch.StreamingUpscaler(cfg, chunk_rows=64)
    sm = lanczos_torch.ShardedStreamingUpscaler(cfg, Mesh.local([cuda] * 4, (1, 4)),
                                                chunk_rows=64)
    assert sm.chunk_path == base.chunk_path == "fused"
    assert np.array_equal(sm(img), base(img))
    video = np.random.default_rng(23).integers(0, 256, (5, 48, 64, 3), dtype=np.uint8)
    vcfg = lanczos_torch.ResampleConfig.from_profile("precise", (48, 64), scale=(2, 1), a=3)
    vu = lanczos_torch.VideoUpscaler(vcfg, batch=3, mesh=Mesh.local([cuda] * 4, (2, 2)))
    assert vu.batch == 4
    assert np.array_equal(vu(video), lanczos_torch.VideoUpscaler(vcfg, batch=3)(video))


@pytest.mark.parametrize("args,shape,kw,counter", [
    ([], (40, 56), dict(scale=(2, 1)), (rc, "fused_resample_fp32")),
    (["--precision", "bf16"], (40, 56), dict(scale=(2, 1), precision="bf16"),
     (rc, "fused_resample_bf16")),
    (["--backend", "pallas", "--out-size", "50x40"], (640, 800), dict(out_shape=(40, 50)),
     (rp, "phase_stream_v_fp32")),
    (["--backend", "pallas", "--a", "215", "--scale", "2/1"], (480, 480), dict(scale=(2, 1), a=215),
     (rs, "shift_resample")),
])
def test_cli_on_the_card_equals_the_upscaler(cuda, tmp_path, args, shape, kw, counter):
    """``cli.main`` with its default ``--device cuda``: one launch of the
    kernel its path routes to, and the file's bytes those of ``Upscaler``
    on the card."""
    from lanczos_torch import cli
    from lanczos_torch.io import read_png, write_png

    img = np.random.default_rng(21).integers(0, 256, shape + (3,), dtype=np.uint8)
    write_png(tmp_path / "in.png", img)
    mod, name = counter
    before = mod.launches[name]
    argv = [str(tmp_path / "in.png"), str(tmp_path / "out.png"), "--no-psnr"] + args
    assert cli.main(argv) == 0
    assert mod.launches[name] == before + 1
    backend = "pallas" if "pallas" in args else "auto"
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", shape, a=kw.pop("a", 3), **kw)
    want = lanczos_torch.Upscaler(cfg, backend=backend)(torch.from_numpy(img).to(cuda))
    assert np.array_equal(read_png(tmp_path / "out.png"), want.cpu().numpy())


@pytest.mark.parametrize("family", ["fused", "kernel 2", "v1"])
def test_constant_planes_on_each_family(cuda, family):
    """The plane of 137 at 24×20, 2/1, a=3 (``tests/test_invariants.py``)
    exactly 137 through each family's kernel; every constant 0..255 at
    48×64 → 96×128 identical bytes to the plain version, with the values
    that lose a level those the plain passes give on the CPU."""
    from lanczos_torch.tools import constant_planes as cp

    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (24, 20), scale=(2, 1), a=3)
    ops = cp.family_ops(cfg, family, cuda)
    y = cp.kernel_of(ops, torch.full((3, 24, 20), 137, dtype=torch.uint8, device=cuda))
    assert bool((y == 137).all())
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (48, 64), scale=(2, 1), a=3)
    lost = cp.plane_losses(cp.family_ops(cfg, family, cuda), cuda)
    assert lost == cp.distinct_row_losses(cp.family_ops(cfg, family, "cpu"))


@pytest.mark.parametrize("family", ["fused", "kernel 2", "v1"])
@pytest.mark.parametrize("filt", ["mitchell", "catmull_rom", "triangle", "box"])
def test_other_filters_on_each_family(cuda, filt, family):
    """Each non-Lanczos filter through each family's kernel: identical
    bytes to its plain version (kernel 2 with dering; v1 at 3/2)."""
    shape, kw = (48, 64), {"scale": (2, 1)}
    if family == "v1":
        kw = {"out_shape": (72, 96)}
    elif family == "kernel 2":
        kw["dering"] = True
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", shape, a=3, filter=filt, **kw)
    variant = {"fused": "mxu", "kernel 2": "v2", "v1": "v1"}[family]
    ops = rc.FusedOps(cfg, cuda, variant=variant)
    assert ops.variant == variant
    x = torch.from_numpy(np.random.default_rng(21).integers(
        0, 256, (3,) + shape, dtype=np.uint8)).to(cuda)
    got = rc.upscale_planar(x, ops)
    torch.cuda.synchronize()
    want = rc.upscale_planar(x.cpu(), rc.FusedOps(cfg, "cpu", variant=variant))
    assert torch.equal(got.cpu(), want)
