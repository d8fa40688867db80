"""Kernel 2 (the port of ``_fused_kernel_v2``) in its plain PyTorch
version, held to the JAX package on the same seeded inputs, and the
routing between the port's kernels.

- the plain version against ``PallasOps(cfg, interpret=True,
  variant="v2")`` and ``Upscaler(cfg, "shift_xla")``: ≤ 1 LSB on ≤ 1% of
  pixels, and identical bytes at the dering shapes below.  Not identical
  everywhere: XLA's CPU backend contracts some of its multiply-adds into
  FMAs, and which ones differs from element to element, so where an exact
  sum lands on an integer (common at 2/1 zero-aligned) its truncation can
  go either way.  The plain version is the unfused IEEE order
  (multiply, then add, in tap order), and the CUDA kernel reproduces it;
- the CUDA kernel's host layout (tiles of whole thread runs, the band in
  16-byte chunks copied inside the image and mapped at its edges, its
  realignment, the staged tile and masked stores) through a numpy
  re-enactment of its loops, byte for byte;
- which kernel ``FusedOps`` picks for each variant and config (v1 or
  kernel 2 exactly where ``PallasOps`` picks them), which kernel
  ``Upscaler(cfg, backend="pallas")`` runs, and which configs raise,
  naming their slice (``tests/test_pallas.py:347-370``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as TpuConfig  # noqa: E402
from lanczos_tpu.models.upscaler import Upscaler as TpuUpscaler  # noqa: E402
from lanczos_tpu.ops.resample_pallas import (  # noqa: E402
    PallasOps,
    resample_2d_pallas,
)

from lanczos_torch.core.config import ResampleConfig  # noqa: E402
from lanczos_torch.models.upscaler import Upscaler  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.ops import resample_shift_cuda as rs  # noqa: E402

# (in (h, w), out (h, w), overrides): every edge mode, both alignments,
# dering on and off, an anisotropic N_v != N_h
CASES = [
    ((24, 40), (48, 80), {"dering": True}),
    ((24, 40), (72, 120), {"dering": True}),
    ((24, 40), (48, 80), {"dering": True, "align": "center"}),
    ((24, 40), (48, 80), {"dering": True, "edge_mode": "reflect"}),
    ((24, 40), (96, 160), {}),
    ((24, 40), (72, 120), {"edge_mode": "drop", "normalize": False}),
    ((24, 40), (48, 120), {"dering": True, "align": "center", "edge_mode": "reflect"}),
]


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _planar(img):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(img, (2, 0, 1))))


def _diff(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def _cfgs(shape, out, kw):
    return (
        TpuConfig.from_profile("precise", shape, out_shape=out, a=3, **kw),
        ResampleConfig.from_profile("precise", shape, out_shape=out, a=3, **kw),
    )


@pytest.mark.parametrize("shape,out,kw", CASES)
def test_plain_v2_matches_jax_v2_and_shift_xla(shape, out, kw):
    tpu_cfg, cfg = _cfgs(shape, out, kw)
    img = _noise(shape + (3,), seed=1)
    ops = rc.FusedOps(cfg, "cpu", variant="v2")
    assert ops.variant == "v2" and ops.kernel == "shift_resample"
    got = rc.resample_2d_cuda(torch.from_numpy(img), ops).numpy()
    want_v2 = np.asarray(
        resample_2d_pallas(img, PallasOps(tpu_cfg, interpret=True, variant="v2"))
    )
    want_sx = np.asarray(TpuUpscaler(tpu_cfg, backend="shift_xla")(img))
    for want in (want_v2, want_sx):
        mx, frac = _diff(got, want)
        assert mx <= 1 and frac <= 0.01, (mx, frac)


@pytest.mark.parametrize("out,kw", [
    ((48, 80), {}), ((72, 120), {}), ((48, 80), {"align": "center"}),
])
def test_plain_v2_bytes_equal_jax_at_dering_shapes(out, kw):
    """24×40 Lanczos-3 dering at 2/1, 3/1 and 2/1 center-aligned, on this
    image: the same bytes as the JAX v2 kernel and the shift path."""
    tpu_cfg, cfg = _cfgs((24, 40), out, dict(kw, dering=True))
    img = _noise((24, 40, 3), seed=0)
    got = rc.resample_2d_cuda(torch.from_numpy(img), rc.FusedOps(cfg, "cpu", variant="v2"))
    pops = PallasOps(tpu_cfg, interpret=True, variant="v2")
    np.testing.assert_array_equal(got.numpy(), np.asarray(resample_2d_pallas(img, pops)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(TpuUpscaler(tpu_cfg, backend="shift_xla")(img))
    )
    # and on the TPU kernel's own tables, the same bytes again
    plan = rs.shift_plan_from_reference(pops)
    again = rs.shift_resample_reference(_planar(img), plan, cfg.out_shape, True)
    assert torch.equal(again, got.permute(2, 0, 1))


@pytest.mark.parametrize("shape,out,kw", CASES)
def test_tables_from_reference_equal_the_ports_own(shape, out, kw):
    tpu_cfg, cfg = _cfgs(shape, out, kw)
    mine = rs.shift_plan(cfg)
    theirs = rs.shift_plan_from_reference(PallasOps(tpu_cfg, interpret=True, variant="v2"))
    for k, v in vars(mine).items():
        np.testing.assert_array_equal(v, getattr(theirs, k), err_msg=k)
    assert mine.tbl_v.dtype == np.float32 and mine.rows.dtype == np.int32


def _tap_sum(w, v, s, dering):
    """The kernel's tap_sum in float32: multiply, then add, in tap order."""
    acc = np.float32(w[0]) * v[0]
    for t in range(1, len(w)):
        acc = acc + np.float32(w[t]) * v[t]
    if dering:
        a, b = v[s - 1], v[s]
        acc = np.minimum(np.maximum(acc, np.minimum(a, b)), np.maximum(a, b))
    return acc


def _emulate_kernel2(x, plan, oh, ow, dering, tiles):
    """Kernel 2's loops in numpy: per (column chunk, row tile, plane), the
    uint8 band in 16-byte chunks from the 16-byte boundary of the source at
    or below the tile's first tap (a straight copy where the chunk lies
    inside the image and W is a multiple of 16, else byte by byte through
    the pad maps; zero past the padded image), realigned to the first tap;
    the vertical pass into a float32 intermediate, all phases of each
    source row; then the horizontal pass, all phases of each source column,
    into the staged uint8 tile, and a masked store."""
    tr, tc = tiles
    nc, h, w = x.shape
    nv, nh, s = plan.nv, plan.nh, plan.support
    taps = 2 * s
    assert tr % (nv * rs.RUN) == 0 and tc % (nh * 16) == 0
    rpb, cpb = tr // nv, tc // nh
    ev = rpb + taps
    mwid = -(-(cpb + taps) // 4) * 4
    bwid = -(-(mwid + 19) // 16) * 16
    hp, wp = h + taps, w + taps
    assert rs.smem_bytes(plan, tr, tc) <= 227 * 1024
    assert rs.smem_bytes(plan, tr, tc) == (
        ev * bwid + 4 * tr * mwid + tr * tc + 4 * (nv + nh) * (taps + 1))
    out = np.full((nc, oh, ow), 7, np.uint8)  # stores must cover every pixel
    for p in range(nc):
        for by in range(-(-oh // tr)):
            for bx in range(-(-ow // tc)):
                y0, x0, k0, j0 = by * tr, bx * tc, by * rpb, bx * cpb
                delta = (j0 - s) & 15
                j_a = j0 - delta
                band = np.zeros((ev, bwid), np.uint8)
                for k in range(ev):
                    sr = plan.rows[k0 + k] if k0 + k < hp else -1
                    if sr < 0:
                        continue
                    for q in range(bwid // 16):
                        jc = j_a + 16 * q
                        if w % 16 == 0 and jc >= s and jc - s + 16 <= w:
                            assert (jc - s) % 16 == 0
                            assert list(plan.cols[jc : jc + 16]) == list(range(jc - s, jc - s + 16))
                            band[k, 16 * q : 16 * q + 16] = x[p, sr, jc - s : jc - s + 16]
                            continue
                        for t in range(16):
                            sc = plan.cols[jc + t] if 0 <= jc + t < wp else -1
                            if sc >= 0:
                                band[k, 16 * q + t] = x[p, sr, sc]
                assert delta + mwid + 4 <= bwid  # the realigning loads read a word ahead
                bandf = band[:, delta : delta + mwid].astype(np.float32)
                mid = np.zeros((tr, mwid), np.float32)
                for q in range(rpb):
                    for ph in range(nv):
                        e0 = q + plan.fp_v[ph] + 1
                        mid[q * nv + ph] = _tap_sum(plan.tbl_v[ph], bandf[e0 : e0 + taps], s, dering)
                stage = np.zeros((tr, tc), np.uint8)
                for c in range(cpb):
                    for ph in range(nh):
                        f0 = c + plan.fp_h[ph] + 1
                        v = _tap_sum(plan.tbl_h[ph], mid[:, f0 : f0 + taps].T, s, dering)
                        stage[:, c * nh + ph] = np.trunc(np.clip(v, 0.0, 255.0)).astype(np.uint8)
                rows_n, cols_n = min(tr, oh - y0), min(tc, ow - x0)
                out[p, y0 : y0 + rows_n, x0 : x0 + cols_n] = stage[:rows_n, :cols_n]
    return out


@pytest.mark.parametrize("shape,out,kw,planes", [
    ((24, 40), (48, 80), {"dering": True}, 3),
    ((23, 37), (69, 111), {"dering": True, "align": "center", "edge_mode": "reflect"}, 2),
    ((20, 70), (40, 280), {"edge_mode": "drop", "normalize": False}, 2),  # ragged chunks
    ((9, 11), (144, 176), {"dering": True}, 1),  # N = 16, whole image in one band
    ((40, 160), (80, 320), {"dering": True}, 1),  # W % 16 == 0: copied chunks, 3 tiles wide
    ((36, 96), (144, 384), {"edge_mode": "reflect"}, 1),  # 4/1, copied and mapped chunks
    ((70, 48), (210, 144), {"dering": True, "align": "center"}, 1),  # 3/1, 4 row tiles
    ((20, 33), (100, 165), {}, 1),  # 5/1: a phase count the thread runs only loop over
])
def test_kernel2_layout_reenacted(shape, out, kw, planes):
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=3, **kw)
    plan = rs.shift_plan(cfg)
    x = _noise((planes,) + shape, seed=2)
    got = _emulate_kernel2(x, plan, *out, cfg.dering, rs.kernel_tiles(plan))
    want = rs.shift_resample_reference(torch.from_numpy(x), plan, out, cfg.dering)
    np.testing.assert_array_equal(got, want.numpy())


def test_kernel_tiles_shrink_to_fit_shared_memory():
    plan = rs.shift_plan(_cfg(dering=True))
    assert rs.kernel_tiles(plan) == (64, 128)
    assert rs.kernel_tiles(rs.shift_plan(_cfg(scale=(3, 1)))) == (60, 96)
    assert rs.kernel_tiles(rs.shift_plan(_cfg(scale=(16, 1)))) == (64, 256)
    big = rs.shift_plan(_cfg(in_shape=(400, 400), a=200, dering=True))
    assert rs.smem_bytes(big, 32, 64) > 227 * 1024
    tr, tc = rs.kernel_tiles(big)
    assert (tr, tc) == (16, 32) and rs.smem_bytes(big, tr, tc) <= 227 * 1024
    huge = ResampleConfig.from_profile("precise", (700, 700), scale=(2, 1), a=300,
                                       dering=True)
    assert rs.kernel_tiles(rs.shift_plan(huge)) is None
    with pytest.raises(NotImplementedError, match="outgrows shared memory"):
        rs.ShiftOps(huge, "cuda")


def test_shift_call_cpu_runs_plain_version_and_counts_no_launch():
    cfg = ResampleConfig.from_profile("precise", (20, 30), scale=(2, 1), dering=True)
    ops = rc.FusedOps(cfg, "cpu", variant="v2")
    before = dict(rs.launches)
    x = _planar(_noise((20, 30, 3), seed=3))
    y = rs.shift_call(ops.shift, x)
    assert y.shape == (3, 40, 60) and y.dtype == torch.uint8
    assert rs.launches == before
    with pytest.raises(ValueError, match="expected"):
        rs.shift_call(ops.shift, x[:, :19])
    with pytest.raises(ValueError, match="call upscale_planar"):
        rc.fused_call(ops, x)


# ---- routing ---------------------------------------------------------------

# no fused plan fits (its band and the window weights of its smallest tile
# outgrow shared memory), kernel 2's smallest tile still does
_BIG_A = dict(in_shape=(480, 480), scale=(2, 1), a=215)


def _cfg(in_shape=(24, 20), scale=(2, 1), a=3, profile="precise", **kw):
    return ResampleConfig.from_profile(profile, in_shape, scale=scale, a=a, **kw)


@pytest.mark.parametrize("kw,variant,picked,kernel", [
    ({}, "auto", "mxu", "fused_resample_fp32"),
    ({"scale": (3, 2)}, "auto", "mxu", "fused_resample_fp32"),
    ({"scale": (1, 2)}, "auto", "mxu", "fused_resample_fp32"),
    ({"dering": True}, "auto", "mxu", "fused_resample_fp32_dering"),
    ({"dering": True, "scale": (3, 2)}, "auto", "mxu", "fused_resample_fp32_dering"),
    ({"dering": True, "edge_mode": "drop"}, "auto", "mxu", "fused_resample_fp32_dering"),
    ({"intermediate_quantize": True, "precision": "bf16"}, "auto", "mxu",
     "fused_resample_bf16_quant"),
    ({"dering": True, "intermediate_quantize": True}, "mxu", "mxu",
     "fused_resample_fp32_dering_quant"),
    ({"dering": True, "order": "width_first"}, "auto", "mxu", "fused_resample_fp32_dering"),
    ({"order": "width_first"}, "auto", "mxu", "fused_resample_fp32"),
    ({"dering": True, **_BIG_A}, "auto", "v2", "shift_resample"),
    ({"dering": True}, "v2", "v2", "shift_resample"),
    ({"scale": (4, 1), "precision": "bf16"}, "v2", "v2", "shift_resample"),
    ({"dering": True, "order": "width_first"}, "v2", "v2", "shift_resample"),
])
def test_variant_picked(kw, variant, picked, kernel):
    cfg = _cfg(**kw)
    ops = rc.FusedOps(cfg, "cpu", variant=variant)
    assert (ops.variant, ops.kernel) == (picked, kernel)
    assert (ops.tr_ops is not None) == (
        cfg.order.value == "width_first" and (cfg.dering or cfg.intermediate_quantize)
    )
    assert (ops.plan is None) == (picked == "v2")


@pytest.mark.parametrize("kw,variant,match,jax_raises", [
    ({"dering": True, **_BIG_A}, "mxu", "no fused plan", None),
    ({**_BIG_A, "dering": True, "scale": (3, 2)}, "auto", "dering config .* gather path",
     None),
    ({"edge_mode": "drop"}, "v2", "drop edges with normalization", True),
    ({"intermediate_quantize": True}, "v2", "quantized intermediate", True),
    ({"dering": True, "edge_mode": "drop", "normalize": False}, "v2",
     "drop-edge dering", True),
    ({"dering": True, "scale": (3, 2)}, "v2", "integer upscale", True),
    ({"dering": True, "scale": (3, 2)}, "v1", "integer upscale", True),
    ({"intermediate_quantize": True, "scale": (3, 2)}, "v1", "quantized intermediate", True),
    ({"profile": "hls", "a": 2}, "auto", "own integer paths", True),
    ({"profile": "c_oracle"}, "auto", "own integer paths", True),
])
def test_unported_routes_raise(kw, variant, match, jax_raises):
    """Each raises ``NotImplementedError`` naming what would take it; where
    the JAX package's ``PallasOps`` raises for the same variant, so does
    the port."""
    cfg = _cfg(**kw)
    with pytest.raises(NotImplementedError, match=match):
        rc.FusedOps(cfg, "cpu", variant=variant)
    if jax_raises is not None:
        tkw = {k: v for k, v in kw.items() if k not in ("profile", "scale", "a")}
        tpu_cfg = TpuConfig.from_profile(
            kw.get("profile", "precise"), (24, 20), scale=kw.get("scale", (2, 1)),
            a=kw.get("a", 3), **tkw,
        )
        if jax_raises:
            with pytest.raises(NotImplementedError):
                PallasOps(tpu_cfg, interpret=True, variant=variant)
        else:
            PallasOps(tpu_cfg, interpret=True, variant=variant)


@pytest.mark.parametrize("kw,variant", [
    ({"scale": (3, 2)}, "v2"),  # rational: PallasOps runs v1
    ({}, "v1"),  # integer: PallasOps runs v2
    ({"scale": (1, 2)}, "v1"),
    ({"scale": (4, 1), "align": "center", "edge_mode": "reflect"}, "v1"),
    ({"scale": (3, 2), "edge_mode": "drop", "normalize": False}, "v2"),
    ({"scale": (17, 1)}, "v2"),  # N > 16: v1
    ({"dering": True}, "v1"),
])
def test_no_plan_variants_follow_pallas_v2(kw, variant):
    """``v1`` and ``v2`` both mean "no fused plan": the port runs kernel 2
    exactly where ``PallasOps(interpret=True, variant=...)`` has ``ops.v2``
    true, and v1 where it is false."""
    cfg = _cfg(**kw)
    ops = rc.FusedOps(cfg, "cpu", variant=variant)
    tkw = {k: v for k, v in kw.items() if k != "scale"}
    tpu_cfg = TpuConfig.from_profile("precise", (24, 20), scale=kw.get("scale", (2, 1)),
                                     a=3, **tkw)
    pops = PallasOps(tpu_cfg, interpret=True, variant=variant)
    want = ("v2", "shift_resample") if pops.v2 else ("v1", "phase_resample_fp32")
    assert (ops.variant, ops.kernel) == want and ops.plan is None
    assert (ops.shift is not None, ops.phase is not None) == (pops.v2, not pops.v2)


@pytest.mark.parametrize("shape,out,a,variant,kernel", [
    ((640, 800), (40, 50), 3, "v1", "phase_resample_fp32"),  # 1/16: no fused plan
    ((24, 20), (48, 40), 3, "mxu", "fused_resample_fp32"),  # 2/1: the fused plan
    ((480, 480), (960, 960), 215, "v2", "shift_resample"),  # integer, no fused plan
])
def test_pallas_backend_routes_as_pallas_auto(shape, out, a, variant, kernel):
    """``Upscaler(cfg, backend="pallas")`` routes as ``PallasOps(variant=
    "auto")`` on a TPU: the fused kernel where a plan fits, else kernel 2
    for any integer config, else v1.  Where no fused plan fits a linear
    config, ``"auto"`` leaves the kernels for the JAX package's fallback
    chain (here the strided path) and ``"cuda"`` keeps raising."""
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=a)
    up = Upscaler(cfg, backend="pallas", device="cpu")
    ops = up._ops[torch.device("cpu")]
    assert (up.backend, up.variant, ops.variant, ops.kernel) == (
        "pallas", "v1" if variant != "mxu" else "mxu", variant, kernel
    )
    if variant != "mxu":
        assert Upscaler(cfg, device="cpu").backend == "shift_xla"
        assert TpuUpscaler(TpuConfig.from_profile("precise", shape, out_shape=out, a=a)
                           ).backend == "shift_xla"
        with pytest.raises(NotImplementedError, match="no fused plan"):
            Upscaler(cfg, backend="cuda", device="cpu")


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        rc.FusedOps(_cfg(), "cpu", variant="v3")


def test_mxu_eligibility_mirrors_jax():
    """As ``test_pallas.py``'s eligibility test: rational scales,
    downscales, dering and drop-edge dering all plan; but unlike the JAX
    package, whose ``auto`` keeps v2 on the CPU, the port's CPU route is
    its CUDA route, so ``auto`` picks the fused kernel there too."""
    for kw in ({"scale": (3, 2), "a": 2}, {"scale": (1, 2), "a": 2},
               {"dering": True, "a": 2}, {"dering": True, "a": 2, "edge_mode": "drop"}):
        cfg = _cfg(**kw)
        assert rc.FusedOps(cfg, "cpu", variant="mxu").plan is not None
        tkw = {k: v for k, v in kw.items() if k not in ("scale", "a")}
        tpu_cfg = TpuConfig.from_profile("precise", (24, 20), scale=kw.get("scale", (2, 1)),
                                         a=kw["a"], **tkw)
        assert PallasOps(tpu_cfg, interpret=True, variant="mxu").mxu is not None
    tpu_ok = TpuConfig.from_profile("precise", (24, 20), scale=(2, 1), a=2)
    assert PallasOps(tpu_ok, interpret=True, variant="auto").mxu is None
    assert rc.FusedOps(_cfg(a=2), "cpu").variant == "mxu"
