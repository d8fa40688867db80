"""The fused kernel's ablation harness (``lanczos_torch.tools.ablate_fused``,
the port of ``tools/ablate_mxu.py``) on the CPU.

- the plain versions of the variants that keep ``full``'s semantics are
  the dense plain version's bytes (both passes dense products over the
  plan's windows, as the dense kernels take them) and agree with
  ``fused_resample_reference``, which sums each output's taps alone in tap
  order, within the fused kernel's limits (fp32 ≤ 1 LSB on ≤ 1% of
  pixels, bf16 ≤ 3 LSB on ≤ 50%); ``ablate_call`` on a CPU tensor runs
  them;
- the three that may differ (``bfmid``, ``novert``, ``nohoriz``) do what
  they say: ``bfmid`` with bf16 weights is ``full``; each deleted pass is
  near the identity on an image that pass leaves unchanged;
- the row-walk kernel's band logic (``rollband``'s kept overlap,
  ``band3``'s aligned-word ring) through a numpy re-enactment, against a
  direct load of every band;
- spec parsing, and the TPU variants with no counterpart exit non-zero
  with their reason.
The kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_torch.core.config import Precision  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.tools import ablate_fused as af  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
KEEPS_FULL = [s for s in af.STAGES if s not in af.DIFFERS]


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _ops(precision, in_shape=(40, 64), out_shape=(80, 128), tile=16, cb=32):
    cfg = af.frame_cfg(Precision(precision), in_shape, out_shape)
    plan = rc.plan_at(cfg, tile, cb)
    return rc.FusedOps(cfg, "cpu", plan)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("stage", KEEPS_FULL)
def test_plain_variants_that_keep_full_are_its_bytes(stage, precision):
    ops = _ops(precision)
    x = torch.from_numpy(_noise((3, 40, 64), seed=0))
    dense = af.ablation_reference(x, ops.plan, Precision(precision), "full",
                                  ops.cfg.out_shape)
    got = af.ablation_reference(x, ops.plan, Precision(precision), stage, ops.cfg.out_shape)
    assert torch.equal(got, dense)
    assert torch.equal(af.ablate_call(ops, x, stage), dense)
    # the production kernel's plain version: the same taps, summed in another order
    sparse = rc.fused_resample_reference(x, ops.plan, precision, ops.cfg.out_shape)
    d = (got.int() - sparse.int()).abs()
    lim, share = af.LIMITS[Precision(precision)]
    assert int(d.max()) <= lim and float((d > 0).float().mean()) <= share


def test_bfmid_is_full_with_bf16_weights_and_near_f32full():
    x = torch.from_numpy(_noise((3, 40, 64), seed=1))
    bf, fp = _ops("bf16"), _ops("fp32")
    assert torch.equal(af.ablate_call(bf, x, "bfmid"), af.ablate_call(bf, x, "full"))
    d = (af.ablate_call(fp, x, "bfmid").int() - rc.fused_call(fp, x).int()).abs()
    assert 0 < int(d.max()) <= 3 and float((d > 0).float().mean()) <= 0.5


@pytest.mark.parametrize("stage,axis", [("novert", 0), ("nohoriz", 1)])
def test_deleted_pass_is_near_identity_where_that_pass_is(stage, axis):
    """At 1/1 on the deleted axis, on an image constant along it, the
    deleted pass's product (normalized taps) and the kernel's copy agree:
    the variant is ``full`` within 1 LSB."""
    in_shape, out_shape = ((40, 64), (40, 128)) if axis == 0 else ((40, 64), (80, 64))
    ops = _ops("fp32", in_shape, out_shape)
    line = _noise((in_shape[1 - axis],), seed=2)
    img = np.broadcast_to(line[None, :] if axis == 0 else line[:, None], in_shape)
    x = torch.from_numpy(np.ascontiguousarray(np.stack([img] * 3)))
    for full in (af.ablate_call(ops, x, "full"), rc.fused_call(ops, x)):
        d = (af.ablate_call(ops, x, stage).int() - full.int()).abs()
        assert int(d.max()) <= 1
    # and on noise it is a different result
    y = torch.from_numpy(_noise((3,) + in_shape, seed=3))
    assert not torch.equal(af.ablate_call(ops, y, stage), af.ablate_call(ops, y, "full"))


def _direct_band(x, plan, i, c0, kh_p):
    """Production's band load of row tile ``i``: rows ``starts_v[i] + k``,
    columns ``c0 + j``, zero past the image and past kh."""
    h, w = x.shape
    band = np.zeros((plan.kv, kh_p), np.float32)
    for k in range(plan.kv):
        r = plan.starts_v[i] + k
        for j in range(plan.kh):
            if r < h and c0 + j < w:
                band[k, j] = x[r, c0 + j]
    return band


def _walk_bands(x, plan, stage, c0, kh_p, walk=8):
    """The row-walk kernel's band of every row tile, block by block
    (``kWalk`` tiles each): ``rollband`` copies the rows the previous band
    holds and loads the rest; ``band3`` reads aligned 4-byte words, zero
    past the image, and shifts by ``c0 % 4``."""
    h, w = x.shape
    bands = {}
    for i0 in range(0, plan.num_tiles, walk):
        prev, old = 0, None
        for s in range(min(walk, plan.num_tiles - i0)):
            i, r0 = i0 + s, plan.starts_v[i0 + s]
            cur = np.zeros((plan.kv, kh_p), np.float32)
            if stage == "rollband":
                delta = r0 - prev
                keep = max(0, plan.kv - delta) if s > 0 and delta >= 0 else 0
                for k in range(plan.kv):
                    if k < keep:
                        cur[k] = old[k + delta]
                    else:
                        for j in range(plan.kh):
                            if r0 + k < h and c0 + j < w:
                                cur[k, j] = x[r0 + k, c0 + j]
                prev, old = r0, cur
            else:
                cw0, nw = c0 & ~3, (plan.kh + 6) // 4
                raw = np.zeros((plan.kv, 4 * nw), np.uint8)
                for k in range(plan.kv):
                    for wd in range(nw):
                        c = cw0 + 4 * wd
                        if r0 + k < h and c < w:
                            raw[k, 4 * wd : 4 * wd + 4] = x[r0 + k, c : c + 4]
                cur[:, : plan.kh] = raw[:, c0 - cw0 : c0 - cw0 + plan.kh]
            bands[i] = cur
    return bands


@pytest.mark.parametrize("stage", ["rollband", "band3"])
@pytest.mark.parametrize("in_shape,out_shape,tile,cb", [
    ((40, 64), (80, 128), 8, 32),  # 2/1: bands overlap, the last ones clip at the bottom
    ((96, 64), (48, 32), 4, 16),  # 1/2: 20 row tiles, a ragged last walk of 4
    ((30, 60), (45, 90), 8, 24),  # 3/2: starts step unevenly; odd column starts
])
def test_walk_bands_equal_direct_loads(stage, in_shape, out_shape, tile, cb):
    ops = _ops("fp32", in_shape, out_shape, tile, cb)
    plan = ops.plan
    x = _noise(in_shape, seed=4)
    kh_p = af.dense_layout(plan, Precision.FP32)["kh_p"]
    assert np.all(np.diff(plan.starts_v) >= 0)
    for c0 in sorted(set(plan.starts_h.tolist())):
        bands = _walk_bands(x, plan, stage, c0, kh_p)
        for i in range(plan.num_tiles):
            np.testing.assert_array_equal(bands[i], _direct_band(x, plan, i, c0, kh_p))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("in_shape,out_shape,tile,cb", [
    ((40, 64), (80, 128), 16, 32),
    ((30, 60), (45, 90), 8, 24),  # 3/2, tile_p and cb_p padding
    ((50, 92), (100, 184), 13, 20),
])
def test_dense_layout_holds_the_plans_matrices(in_shape, out_shape, tile, cb, precision):
    """The dense kernels' layout: the plan's matrices after ``plan_weights``,
    transposed and zero-padded to the register tile, with the launch
    arguments the dense kernels take."""
    plan = _ops(precision, in_shape, out_shape, tile, cb).plan
    lay = af.dense_layout(plan, Precision(precision))
    wv, wh = rc.plan_weights(plan, Precision(precision))
    assert lay["tile_p"] % 8 == 0 and lay["cb_p"] % 4 == 0 and lay["kh_p"] % 8 == 0
    assert lay["wvT"].shape == (plan.num_tiles, plan.kv, lay["tile_p"])
    assert lay["wh"].shape == (wh.shape[0], plan.kh, lay["cb_p"])
    np.testing.assert_array_equal(lay["wvT"][:, :, : plan.tile_out], wv.transpose(0, 2, 1))
    np.testing.assert_array_equal(lay["wh"][:, :, : plan.cb], wh)
    assert not lay["wvT"][:, :, plan.tile_out :].any() and not lay["wh"][:, :, plan.cb :].any()
    assert (lay["tile"], lay["cb"], lay["kv"], lay["kh"]) == (
        plan.tile_out, plan.cb, plan.kv, plan.kh)


def test_parse_spec():
    assert af.parse_spec("64:full") == af.Spec(64, Precision.BF16, "full")
    assert af.parse_spec("32:f32swpipe") == af.Spec(32, Precision.FP32, "swpipe")
    assert str(af.parse_spec("128:f32bfmid")) == "128:f32bfmid"
    for bad, match in (("full", "tile:variant"), ("x:full", "tile:variant"),
                       ("0:full", "tile:variant"), ("64:fulll", "unknown variant")):
        with pytest.raises(ValueError, match=match):
            af.parse_spec(bad)


@pytest.mark.parametrize("name", sorted(af.NO_COUNTERPART))
def test_no_counterpart_names_exit_nonzero(name, capsys):
    assert af.main([f"64:{name}", "64:full"]) != 0
    err = capsys.readouterr().err
    assert "no counterpart" in err and af.NO_COUNTERPART[name] in err


def test_module_entry_point_refuses_stackh():
    res = subprocess.run(
        [sys.executable, "-m", "lanczos_torch.tools.ablate_fused", "64:stackh"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0 and "MXU" in res.stderr and res.stdout == ""


def test_ablate_call_refuses_what_the_kernels_do_not_take():
    ops = _ops("bf16")
    before = dict(af.launches)
    x = torch.from_numpy(_noise((3, 40, 64), seed=5))
    with pytest.raises(ValueError, match="unknown stage"):
        af.ablate_call(ops, x, "stackh")
    with pytest.raises(ValueError, match="expected"):
        af.ablate_call(ops, x[:, :39], "full")
    cfg = af.frame_cfg(Precision.BF16, (40, 64), (80, 128))
    dering = rc.FusedOps(cfg.__class__.from_profile("precise", (40, 64), scale=(2, 1),
                                                    dering=True), "cpu")
    with pytest.raises(ValueError, match="linear"):
        af.ablate_call(dering, x, "full")
    assert af.launches == before  # the CPU runs the plain versions
