"""The v1 kernel (the port of ``_fused_kernel``) in its plain PyTorch
version, held to the JAX package's v1 kernel on the same seeded inputs.

- the plain version, on the port's own plan (``phase_plan``) and on the
  TPU kernel's numbers (``phase_plan_from_reference``), against
  ``PallasOps(cfg, interpret=True, variant="v1")``'s ``upscale_planar``:
  fp32 ≤ 1 LSB on ≤ 1% of pixels (only the order of a rational axis's sums
  differs: the TPU's dense hi/lo products, the port's taps; measured
  0–0.074%).  bf16 is held to the JAX *fp32* v1 under ≤ 3 LSB on ≤ 50%:
  the JAX bf16 v1 rounds each weight to nearest, the port keeping each
  phase's tap sum, so their bf16 bytes are not one result; and the JAX
  bf16 v1 is past that contract itself on center-aligned shapes (max 2 on
  56% of pixels against the fp32 gather at 30×40→45×60);
- the two plans' tables, floors and pad maps, equal;
- each design's host layout through a numpy re-enactment of its kernel's
  loops, byte for byte against the plain version: the generic tile kernel
  (tiles, per-tile band through the pad maps, staged tables, masked
  stores, the bf16 intermediate); the streamed vertical pass (live-output
  accumulators, the reordered weight table, chunks of rows, 16-byte and
  byte copies) and the horizontal pass over its intermediate, fp32 and
  bf16; the window design (band origin moved to the source's 16-byte
  boundary, chunks copied or mapped byte by byte, the period walk over
  register windows, the run-time form, staged tile and masked stores);
- the selector (which design a plan gets) and each layout's shared memory;
- the two streamed kernels' plain versions, composed, against the plain
  version of the whole.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as TpuConfig  # noqa: E402
from lanczos_tpu.ops.resample_pallas import PallasOps  # noqa: E402
from lanczos_tpu.ops.resample_pallas import upscale_planar as tpu_upscale_planar  # noqa: E402

from lanczos_torch.core.config import ResampleConfig  # noqa: E402
from lanczos_torch.ops import _build  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.ops import resample_phase_cuda as rp  # noqa: E402
from test_torch_fma import fma32  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}

# (in (h, w), out (h, w), overrides)
CASES = [
    ((24, 40), (36, 60), {}),  # 3/2
    ((36, 60), (24, 40), {}),  # 2/3
    ((48, 80), (24, 40), {}),  # 1/2, support 6
    ((256, 256), (16, 16), {}),  # 1/16, support 48
    ((24, 40), (48, 60), {}),  # mixed: 2/1 (integer) by 3/2
    ((24, 32), (24, 48), {}),  # 1/1 (integer) by 3/2
    ((24, 40), (36, 20), {}),  # anisotropic supports: 3/2 (3) by 1/2 (6)
    ((24, 40), (36, 60), {"edge_mode": "reflect"}),
    ((24, 40), (36, 60), {"edge_mode": "drop", "normalize": False}),
    ((30, 40), (45, 60), {"align": "center"}),
    ((25, 41), (37, 61), {}),  # ragged: N = 37 and 61 phases, no whole tiles
    ((32, 48), (2, 3), {"edge_mode": "reflect"}),  # reflect, support 48 > the image
]


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _diff(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def _cfgs(shape, out, kw, precision="fp32"):
    return (
        TpuConfig.from_profile("precise", shape, out_shape=out, a=3, **kw),
        ResampleConfig.from_profile("precise", shape, out_shape=out, a=3,
                                    precision=precision, **kw),
    )


def _jax_v1(tpu_cfg, x):
    pops = PallasOps(tpu_cfg, interpret=True, variant="v1")
    assert not pops.v2 and pops.mxu is None
    return pops, np.asarray(tpu_upscale_planar(x, pops))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,kw", CASES)
def test_plain_v1_matches_jax_v1(shape, out, kw, precision):
    tpu_cfg, cfg = _cfgs(shape, out, kw, precision)
    x = _noise((3,) + shape, seed=0)
    pops, want = _jax_v1(tpu_cfg, x)
    for plan in (rp.phase_plan(cfg), rp.phase_plan_from_reference(pops)):
        got = rp.phase_resample_reference(torch.from_numpy(x), plan, precision, out)
        assert got.shape == (3,) + out and got.dtype == torch.uint8
        mx, frac = _diff(got.numpy(), want)
        lim, frac_lim = LIMITS[precision]
        assert mx <= lim and frac <= frac_lim, (mx, frac)


@pytest.mark.parametrize("shape,out,kw", CASES)
def test_plan_from_reference_equals_the_ports_own(shape, out, kw):
    tpu_cfg, cfg = _cfgs(shape, out, kw)
    mine = rp.phase_plan(cfg)
    theirs = rp.phase_plan_from_reference(PallasOps(tpu_cfg, interpret=True, variant="v1"))
    for ax in ("v", "h"):
        a, b = getattr(mine, ax), getattr(theirs, ax)
        for k, v in vars(a).items():
            np.testing.assert_array_equal(v, getattr(b, k), err_msg=f"{ax}.{k}")
        assert a.tbl.dtype == np.float32 and a.pad.dtype == a.floors.dtype == np.int32


def test_batched_planar_through_fused_ops():
    tpu_cfg, cfg = _cfgs((24, 40), (36, 60), {})
    x = _noise((2, 3, 24, 40), seed=1)
    ops = rc.FusedOps(cfg, "cpu", variant="v1")
    assert (ops.variant, ops.kernel) == ("v1", "phase_resample_fp32")
    got = rc.upscale_planar(torch.from_numpy(x), ops)
    assert got.shape == (2, 3, 36, 60)
    _, want = _jax_v1(tpu_cfg, x)
    mx, frac = _diff(got.numpy(), want)
    assert mx <= 1 and frac <= 0.01, (mx, frac)
    # the interleaved entry point on one image agrees with the planar batch
    one = rc.resample_2d_cuda(torch.from_numpy(np.ascontiguousarray(x[1].transpose(1, 2, 0))), ops)
    assert torch.equal(one.permute(2, 0, 1), got[1])


def _tap_sum(w, v):
    """The kernel's sum in float32, in tap order: the first product, then
    one rounding a tap (``__fmaf_rn``)."""
    acc = np.float32(w[0]) * v[0]
    for t in range(1, len(w)):
        acc = fma32(acc, w[t], v[t])
    return acc


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


def _emulate_v1(x, plan, out, precision, tr, tc):
    """The generic kernel's loops in numpy: per (column tile, row tile,
    plane), the uint8 band its outputs read, through the pad maps; the
    staged tables (whole, or the tile's rows where the axis has more phases
    than the tile) and band offsets; the vertical pass into the
    intermediate (rounded to bf16 where the config does); then the
    horizontal pass and a masked trunc-clip store."""
    (oh, ow), (nc, h, w) = out, x.shape
    (base_v, ph_v), (base_h, ph_h) = plan.v.taps(oh), plan.h.taps(ow)
    tv, th = plan.v.table(precision), plan.h.table(precision)
    taps_v, taps_h = 2 * plan.v.support, 2 * plan.h.support
    hp, wp = h + taps_v, w + taps_h
    ev_max, eh_max = rp._extent(base_v, tr, taps_v), rp._extent(base_h, tc, taps_h)
    res = np.full((nc, oh, ow), 7, np.uint8)  # stores must cover every pixel
    for p in range(nc):
        for y0 in range(0, oh, tr):
            for x0 in range(0, ow, tc):
                rows_n, cols_n = min(tr, oh - y0), min(tc, ow - x0)
                r0, c0 = base_v[y0], base_h[x0]
                ev = base_v[y0 + rows_n - 1] - r0 + taps_v
                eh = base_h[x0 + cols_n - 1] - c0 + taps_h
                assert ev <= ev_max and eh <= eh_max
                r, c = r0 + np.arange(ev), c0 + np.arange(eh)
                sr = np.where(r < hp, plan.v.pad[np.minimum(r, hp - 1)], -1)
                sc = np.where(c < wp, plan.h.pad[np.minimum(c, wp - 1)], -1)
                ok = (sr[:, None] >= 0) & (sc[None, :] >= 0)
                band = np.where(ok, x[p][np.maximum(sr, 0)[:, None], np.maximum(sc, 0)], 0)
                band = band.astype(np.uint8).astype(np.float32)
                if plan.v.n <= tr:  # the whole table, rows by phase
                    wv, wrow_v = tv, ph_v[y0 : y0 + rows_n]
                else:  # the tile's own rows
                    wv, wrow_v = tv[ph_v[y0 : y0 + rows_n]], np.arange(rows_n)
                if plan.h.n <= tc:
                    wh, wrow_h = th, ph_h[x0 : x0 + cols_n]
                else:
                    wh, wrow_h = th[ph_h[x0 : x0 + cols_n]], np.arange(cols_n)
                off_v = base_v[y0 : y0 + rows_n] - r0
                off_h = base_h[x0 : x0 + cols_n] - c0
                mid = np.zeros((rows_n, eh), np.float32)
                for rr in range(rows_n):
                    mid[rr] = _tap_sum(wv[wrow_v[rr]], band[off_v[rr] : off_v[rr] + taps_v])
                if plan.rounds_mid(precision):
                    mid = _bf16(mid)
                for cc in range(cols_n):
                    v = _tap_sum(wh[wrow_h[cc]], mid[:, off_h[cc] : off_h[cc] + taps_h].T)
                    res[p, y0 : y0 + rows_n, x0 + cc] = np.trunc(np.clip(v, 0, 255)).astype(np.uint8)
    return res


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,kw,tiles", [
    ((24, 40), (36, 60), {}, None),
    ((23, 37), (34, 55), {"align": "center", "edge_mode": "reflect"}, (8, 16)),  # ragged
    ((256, 256), (16, 16), {}, (4, 8)),  # 1/16: bands of 144 x 208
    ((20, 30), (40, 45), {"edge_mode": "drop", "normalize": False}, (16, 32)),  # 2/1 by 3/2
    ((24, 40), (48, 40), {}, (8, 16)),  # rational vertical by 1/1: fp32 intermediate in bf16
    ((25, 41), (37, 61), {}, (8, 16)),  # 37 and 61 phases: the tile's own table rows
])
def test_v1_kernel_layout_reenacted(shape, out, kw, tiles, precision):
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=3,
                                      precision=precision, **kw)
    plan = rp.phase_plan(cfg)
    mid_bytes = 2 if plan.rounds_mid(precision) else 4
    if tiles is None:
        lay = rp.generic_tiles(plan, out, mid_bytes)
        tiles = lay["tr"], lay["tc"]
    x = _noise((2,) + shape, seed=2)
    got = _emulate_v1(x, plan, out, precision, *tiles)
    want = rp.phase_resample_reference(torch.from_numpy(x), plan, precision, out)
    np.testing.assert_array_equal(got, want.numpy())


def _emulate_stream_v(x, plan, precision, oh, rpc):
    """The streamed vertical pass's loops in numpy: per plane, chunk of
    ``rpc`` output rows and warp stripe of 128 columns, the walk down the
    padded rows (each through the row map, copied in 16-byte chunks where
    the width allows, else byte by byte, zero past the right edge), the
    2a live accumulators fed from the reordered table, and the store and
    aging at the end of each period; bf16 where the config rounds."""
    nc, h, w = x.shape
    v = plan.v
    d, taps = v.d, 2 * v.support
    live, b0, hp = taps // d, int(v.floors[0]) + 1, h + taps
    wt = rp.stream_table(v, precision)
    assert wt.shape == (d, -(-live // 4) * 4) and h == oh * d
    vec_in = w % 16 == 0
    mid = np.full((nc, oh, w), np.nan, np.float32)  # stores must cover every value
    for p in range(nc):
        for ra in range(0, oh, rpc):
            rb = min(ra + rpc, oh)
            i0, nrows = ra * d + b0, (rb - ra + live - 1) * d
            for cw0 in range(0, w, rp.STREAM_STRIPE):
                acc = np.zeros((live, rp.STREAM_STRIPE), np.float32)
                j, q = 0, ra
                for rr in range(nrows):
                    sr = v.pad[i0 + rr] if i0 + rr < hp else -1
                    stage = np.zeros(rp.STREAM_STRIPE, np.uint8)
                    if sr >= 0 and vec_in:
                        for ch in range(8):
                            col = cw0 + 16 * ch
                            if col < w:
                                stage[16 * ch : 16 * ch + 16] = x[p, sr, col : col + 16]
                    elif sr >= 0:
                        n = min(rp.STREAM_STRIPE, w - cw0)
                        stage[:n] = x[p, sr, cw0 : cw0 + n]
                    xv = stage.astype(np.float32)
                    for k in range(live):
                        acc[k] = fma32(acc[k], wt[j, k], xv)
                    j += 1
                    if j == d:
                        j, r = 0, q - (live - 1)
                        if r >= ra:
                            n = min(rp.STREAM_STRIPE, w - cw0)
                            mid[p, r, cw0 : cw0 + n] = acc[live - 1, :n]
                        acc[1:] = acc[:-1].copy()
                        acc[0] = 0
                        q += 1
                assert q == rb + live - 1
    assert not np.isnan(mid).any()
    return _bf16(mid) if plan.rounds_mid(precision) else mid


def _emulate_stream_h(mid, plan, precision, ow, tc, eh_max):
    """The streamed design's horizontal pass in numpy: per (column tile, 32
    rows, plane), the padded columns the tile reads, through the column
    map; a lane a row, a warp a column; staged tile, masked store."""
    nc, oh, w = mid.shape
    hz = plan.h
    taps = 2 * hz.support
    base_h, ph_h = hz.taps(ow)
    th, wp = hz.table(precision), w + taps
    res = np.full((nc, oh, ow), 7, np.uint8)
    for p in range(nc):
        for y0 in range(0, oh, rp.STREAM_H_ROWS):
            rows_n = min(rp.STREAM_H_ROWS, oh - y0)
            for x0 in range(0, ow, tc):
                cols_n = min(tc, ow - x0)
                c0 = base_h[x0]
                eh = base_h[x0 + cols_n - 1] - c0 + taps
                assert eh <= eh_max
                c = c0 + np.arange(eh)
                sc = np.where(c < wp, hz.pad[np.minimum(c, wp - 1)], -1)
                band = np.where(sc[None, :] >= 0, mid[p, y0 : y0 + rows_n][:, np.maximum(sc, 0)],
                                np.float32(0))
                for cc in range(cols_n):
                    row = th[ph_h[x0 + cc]] if hz.n <= tc else th[ph_h[x0 : x0 + cols_n]][cc]
                    off = base_h[x0 + cc] - c0
                    val = _tap_sum(row, band[:, off : off + taps].T)
                    res[p, y0 : y0 + rows_n, x0 + cc] = np.trunc(np.clip(val, 0, 255)).astype(np.uint8)
    return res


STREAM_CASES = [  # (in, out, overrides, rows a chunk)
    ((256, 256), (16, 16), {}, 5),  # 1/16, 16-byte copies, two stripes, ragged chunks
    ((128, 208), (32, 52), {}, 7),  # 1/4: the second stripe is 80 columns
    ((64, 50), (16, 25), {}, 3),  # 1/4 by 1/2, W % 16 != 0: the byte path
    ((32, 48), (2, 3), {"edge_mode": "reflect"}, 2),  # reflect, support 48 > the image
    ((64, 64), (8, 16), {"edge_mode": "drop", "normalize": False}, 8),  # zero edges, 1/8 by 1/4
    ((64, 64), (16, 16), {"align": "center"}, 16),  # the first tap moves with the alignment
    ((64, 48), (8, 72), {"a": 2}, 3),  # support 2: 4 live rows; 1/8 by 3/2
    ((80, 32), (16, 32), {"a": 4}, 4),  # support 4: 8 live rows; 1/5 by 1/1 (fp32 mid in bf16)
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,kw,rpc", STREAM_CASES)
def test_stream_kernels_layout_reenacted(shape, out, kw, rpc, precision):
    kw = dict(kw)
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=kw.pop("a", 3),
                                      precision=precision, **kw)
    ops = rp.PhaseOps(cfg, "cpu")
    assert ops.design == "stream" and len(ops.kernels) == 2
    plan, x = ops.plan, _noise((2,) + shape, seed=4)
    xt = torch.from_numpy(x)
    mid = _emulate_stream_v(x, plan, precision, out[0], rpc)
    want_mid = rp.stream_v_reference(xt, plan, precision, out[0])
    assert want_mid.dtype == (torch.bfloat16 if plan.rounds_mid(precision) else torch.float32)
    np.testing.assert_array_equal(mid, want_mid.float().numpy())
    got = _emulate_stream_h(mid, plan, precision, out[1], ops.layout["tc"], ops.layout["eh"])
    want = rp.phase_resample_reference(xt, plan, precision, out)
    np.testing.assert_array_equal(got, want.numpy())
    # the two kernels' plain versions, composed, are the plain version of the whole
    assert torch.equal(rp.stream_h_reference(want_mid, plan, precision, out[1]), want)
    # and so are the wrappers on the CPU, which count no launch
    before = dict(rp.launches)
    assert torch.equal(rp.stream_h_call(ops, rp.stream_v_call(ops, xt)), want)
    assert torch.equal(rp.phase_call(ops, xt), want) and rp.launches == before


def _emulate_window(x, plan, precision, out, pv, ph, templ):
    """The window kernel's loops in numpy: per (column chunk, row tile,
    plane), the band with its origin moved left to the source's 16-byte
    boundary (chunks inside the image copied, the others mapped byte by
    byte, zero past the padded image), the vertical pass over register
    windows of K periods of rows (or a period a step in the run-time
    form), the horizontal pass over windows of K periods of columns, the
    staged tile and the masked store."""
    (oh, ow), (nc, h, w) = out, x.shape
    v, hz = plan.v, plan.h
    tv, th = v.table(precision), hz.table(precision)
    taps_v, taps_h = 2 * v.support, 2 * hz.support
    f0v, f0h = int(v.floors.min()) + 1, int(hz.floors.min()) + 1
    rel_v, rel_h = v.floors - v.floors.min(), hz.floors - hz.floors.min()
    kv = -(-4 // v.d) if templ else 1
    kh = -(-4 // hz.d) if templ else 1
    if templ:
        assert rel_v.tolist() == [p * v.d // v.n for p in range(v.n)]
        assert rel_h.tolist() == [p * hz.d // hz.n for p in range(hz.n)]
    tr, tc = v.n * pv, hz.n * ph
    assert pv % kv == 0 and ph % kh == 0 and tr % 2 == 0 and tc % 16 == 0
    ev = (pv - 1) * v.d + int(rel_v.max()) + taps_v
    mwid = -(-((ph - 1) * hz.d + int(rel_h.max()) + taps_h) // 4) * 4
    bwid = -(-(mwid + 19) // 16) * 16
    hp, wp = h + taps_v, w + taps_h
    vec_in = w % 16 == 0
    res = np.full((nc, oh, ow), 7, np.uint8)
    for p in range(nc):
        for by in range(-(-oh // tr)):
            for bx in range(-(-ow // tc)):
                k0, j0 = by * pv * v.d + f0v, bx * ph * hz.d + f0h
                delta = (j0 - hz.support) % 16
                ja = j0 - delta
                band = np.zeros((ev, bwid), np.uint8)
                for k in range(ev):
                    sr = v.pad[k0 + k] if k0 + k < hp else -1
                    if sr < 0:
                        continue
                    for q in range(bwid // 16):
                        jc = ja + 16 * q
                        if vec_in and jc >= hz.support and jc - hz.support + 16 <= w:
                            c = jc - hz.support
                            assert c % 16 == 0
                            band[k, 16 * q : 16 * q + 16] = x[p, sr, c : c + 16]
                        else:
                            for t in range(16):
                                sc = hz.pad[jc + t] if 0 <= jc + t < wp else -1
                                band[k, 16 * q + t] = x[p, sr, sc] if sc >= 0 else 0
                cols = band[:, delta : delta + mwid].astype(np.float32)  # the realigned words
                mid = np.full((tr, mwid + 4), np.nan, np.float32)  # the slack is never summed
                for qg in range(pv // kv):
                    win = cols[qg * kv * v.d : qg * kv * v.d + (kv - 1) * v.d
                               + int(rel_v.max()) + taps_v]
                    for ph_ in range(v.n):
                        for k in range(kv):
                            s0 = k * v.d + rel_v[ph_]
                            mid[(qg * kv + k) * v.n + ph_, :mwid] = _tap_sum(
                                tv[ph_], win[s0 : s0 + taps_v])
                if plan.rounds_mid(precision):
                    mid = _bf16(mid)
                stage = np.zeros((tr, tc), np.uint8)
                run = kh * hz.d
                for cg in range(ph // kh):
                    win = mid[:, run * cg : run * cg + (kh - 1) * hz.d + int(rel_h.max()) + taps_h]
                    for ph_ in range(hz.n):
                        for k in range(kh):
                            s0 = k * hz.d + rel_h[ph_]
                            val = _tap_sum(th[ph_], win[:, s0 : s0 + taps_h].T)
                            assert not np.isnan(val).any()
                            stage[:, (cg * kh + k) * hz.n + ph_] = np.trunc(
                                np.clip(val, 0, 255)).astype(np.uint8)
                y0, x0 = by * tr, bx * tc
                rows_n, cols_n = min(tr, oh - y0), min(tc, ow - x0)
                res[p, y0 : y0 + rows_n, x0 : x0 + cols_n] = stage[:rows_n, :cols_n]
    return res


WINDOW_CASES = [  # (in, out, overrides, (pv, ph) or None for the layout's, templated)
    ((24, 40), (36, 60), {}, None, True),  # 3/2
    ((32, 64), (48, 96), {}, (4, 16), True),  # 3/2, 16-byte chunks, 4 x 2 blocks
    ((27, 48), (36, 64), {}, (2, 4), True),  # 4/3, blocks of 8 x 16
    ((24, 48), (24, 64), {}, (4, 4), True),  # the desqueeze: 1/1 by 4/3
    ((27, 40), (36, 40), {}, (2, 16), True),  # 4/3 by 1/1: fp32 intermediate in bf16
    ((24, 40), (48, 60), {"edge_mode": "reflect"}, None, True),  # 2/1 by 3/2
    ((24, 40), (36, 80), {"edge_mode": "drop", "normalize": False}, None, True),  # 3/2 by 2/1
    ((30, 40), (45, 60), {"align": "center"}, None, False),  # center: the run-time form
    ((24, 40), (30, 50), {}, (2, 16), False),  # 5/4 on both axes
    ((24, 40), (36, 60), {"a": 2}, None, False),  # 3/2 at support 2
    ((23, 37), (46, 74), {"a": 4, "edge_mode": "reflect"}, None, False),  # 2/1 x 2/1, 8 taps
    ((6, 9), (9, 12), {"edge_mode": "reflect"}, None, True),  # 3/2 by 4/3 is no built pair
]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,out,kw,periods,templ", WINDOW_CASES)
def test_window_kernel_layout_reenacted(shape, out, kw, periods, templ, precision):
    kw = dict(kw)
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=kw.pop("a", 3),
                                      precision=precision, **kw)
    plan = rp.phase_plan(cfg)
    assert rp.choose_design(plan) == "window"
    lay = rp.window_layout(plan)
    if shape == (6, 9):  # each axis has a compile-time form, the pair has not
        assert rp._templated_axis(plan.v) and rp._templated_axis(plan.h)
        templ = False
    assert lay["templ"] == templ == rp.window_templated(plan)
    pv, ph = periods or (lay["pv"], lay["ph"])
    x = _noise((2,) + shape, seed=5)
    got = _emulate_window(x, plan, precision, out, pv, ph, templ)
    want = rp.phase_resample_reference(torch.from_numpy(x), plan, precision, out)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("shape,out,kw,design,kernels", [
    ((4320, 7680), (270, 480), {}, "stream", ("phase_stream_v_fp32", "phase_stream_h_fp32")),
    ((4320, 7680), (270, 480), {"precision": "bf16"}, "stream",
     ("phase_stream_v_bf16", "phase_stream_h_bf16")),
    ((1440, 2560), (2160, 3840), {}, "window", ("phase_window_fp32",)),
    ((1440, 2560), (2160, 3840), {"precision": "bf16"}, "window", ("phase_window_bf16",)),
    ((1080, 1440), (1440, 1920), {}, "window", ("phase_window_fp32",)),  # 4/3
    ((2160, 2880), (2160, 3840), {"precision": "bf16"}, "window", ("phase_window_bf16",)),
    ((2880, 2160), (3840, 2160), {"precision": "bf16"}, "window", ("phase_window_fp32",)),
    ((25, 41), (37, 61), {}, "generic", ("phase_resample_fp32",)),
    ((36, 60), (24, 40), {}, "generic", ("phase_resample_fp32",)),  # 2/3: 10 taps
    ((64, 64), (32, 32), {}, "generic", ("phase_resample_fp32",)),  # 1/2: not steep enough
    ((64, 256), (64, 16), {}, "generic", ("phase_resample_fp32",)),  # steep across only
    ((96, 64), (18, 64), {}, "generic", ("phase_resample_fp32",)),  # 3/16: three phases
    ((1440, 2560), (2160, 3840), {"align": "center"}, "window", ("phase_window_fp32",)),
])
def test_selector_picks_the_design(shape, out, kw, design, kernels):
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=3, **kw)
    ops = rp.PhaseOps(cfg, "cpu")
    assert (ops.design, ops.kernels) == (design, kernels)
    assert rp.choose_design(ops.plan) == design
    assert set(ops.kernels) <= set(rp.launches)
    forced = rp.PhaseOps(cfg, "cpu", design="generic")
    assert forced.design == "generic" and forced.kernels == (forced.kernel,)
    assert forced.kernel == ops.kernel and set(forced.layout) == {"tr", "tc", "ev", "eh", "smem"}
    if design != "generic":
        with pytest.raises(ValueError, match="does not take this plan"):
            rp.PhaseOps(cfg, "cpu", design="stream" if design == "window" else "window")
        templated = "align" not in kw
        if design == "window":
            assert ops.layout["templ"] == templated
    with pytest.raises(ValueError, match="unknown design"):
        rp.PhaseOps(cfg, "cpu", design="dense")
    assert rc.FusedOps(cfg, "cpu", variant="v1", design="generic").phase.design == "generic"


@pytest.mark.parametrize("shape,out,kw", [
    ((4320, 7680), (270, 480), {}),
    ((4320, 7680), (270, 480), {"precision": "bf16"}),
    ((1440, 2560), (2160, 3840), {}),
    ((2160, 2880), (2160, 3840), {}),
    ((1080, 1440), (1440, 1920), {}),
    ((1080, 1920), (1350, 2400), {}),  # 5/4: the run-time window form
    ((2160, 3840), (2160 * 16 // 15, 4096), {}),  # 16/15: 16 phases an axis
    ((1080, 1920), (2160, 3840), {"a": 4, "precision": "bf16"}),
    ((1000, 1000), (1480, 1488), {}),  # 37/25 by 186/125: generic
    ((8640, 15360), (270, 480), {}),  # 1/32: support 96
    ((4320, 7680), (1080, 1920), {"a": 4}),  # 1/4 at support 16: 8 live rows
])
def test_each_layout_fits_shared_memory(shape, out, kw):
    kw = dict(kw)
    cfg = ResampleConfig.from_profile("precise", shape, out_shape=out, a=kw.pop("a", 3), **kw)
    for design in ("auto", "generic"):
        ops = rp.PhaseOps(cfg, "cpu", design=design)
        assert 0 < ops.layout["smem"] <= _build.SMEM_LIMIT
        plan, lay = ops.plan, ops.layout
        if ops.design == "stream":
            assert lay["smem"] == rp.stream_h_smem_bytes(plan, lay["tc"], lay["eh"]) <= 48 * 1024
            assert rp.stream_v_smem_bytes(plan.v) <= 48 * 1024
            live = 2 * plan.v.support // plan.v.d
            for nc in (1, 3, 48):
                rpc = rp.stream_chunk_rows(out[0], shape[1], nc, live)
                assert 1 <= rpc <= out[0]
                warps = -(-shape[1] // rp.STREAM_STRIPE) * nc * -(-out[0] // rpc)
                assert warps >= rp.STREAM_MIN_WARPS * rp.SM_COUNT or rpc == 1
        elif ops.design == "window":
            tr, tc = plan.v.n * lay["pv"], plan.h.n * lay["ph"]
            assert tr % 2 == 0 and tc % 16 == 0 and lay["smem"] <= 64 * 1024
            assert lay["smem"] == rp.window_smem_bytes(plan, lay["pv"], lay["ph"])
            if lay["templ"]:
                assert lay["pv"] % -(-4 // plan.v.d) == 0 and lay["ph"] % -(-4 // plan.h.d) == 0
        else:
            mid_bytes = 2 if plan.rounds_mid(cfg.precision) else 4
            assert lay["smem"] == rp.generic_smem_bytes(
                plan, lay["tr"], lay["tc"], lay["ev"], lay["eh"], mid_bytes)


def test_thumbnail_tiles_fit_shared_memory():
    """8K → 480×270 (1/16, support 48): no fused plan fits, and v1 streams
    it: 6 live rows from a (16, 8) table, 34 output rows a chunk at 3
    planes, and a horizontal pass of 32 × 16 outputs from 336 padded
    columns.  The generic design, forced, still shrinks its block to 8×32
    outputs with an fp32 intermediate and 16×32 with a bf16 one, and a
    16×32 tile with an fp32 intermediate would not fit."""
    cfg = ResampleConfig((4320, 7680), (270, 480), a=3)
    assert rc.fused_plan(cfg) is None and rc.pallas_variant(cfg) == "v1"
    plan = rp.phase_plan(cfg)
    assert (plan.v.support, plan.h.support) == (48, 48)
    assert not plan.v.integer and not plan.h.integer
    ops = rp.PhaseOps(cfg, "cpu")
    assert ops.design == "stream" and (ops.layout["tc"], ops.layout["eh"]) == (16, 336)
    wt = rp.stream_table(plan.v, "fp32")
    assert wt.shape == (16, 8) and not wt[:, 6:].any()
    np.testing.assert_array_equal(wt[5, :6], plan.v.tbl[0][5::16])
    assert rp.stream_chunk_rows(270, 7680, 3, 6) == 34  # 8 chunks: 1440 warps on 132 SMs
    assert rp.stream_v_smem_bytes(plan.v) == 3 * 32 * 128 + 4 * 16 * 8
    fp32, bf16 = (rp.generic_tiles(plan, (270, 480), b) for b in (4, 2))
    assert [fp32[k] for k in ("tr", "tc", "ev", "eh")] == [8, 32, 208, 592]
    assert [bf16[k] for k in ("tr", "tc", "ev", "eh")] == [16, 32, 336, 592]
    assert rp.generic_smem_bytes(plan, 16, 32, 336, 592, 4) > _build.SMEM_LIMIT
    # the 3/2 upscale, forced generic, keeps the largest tile
    fsr = rp.phase_plan(ResampleConfig((1440, 2560), (2160, 3840), a=3))
    lay = rp.generic_tiles(fsr, (2160, 3840), 4)
    assert (lay["tr"], lay["tc"]) == (32, 128)


def test_phase_call_cpu_runs_plain_version_and_counts_no_launch():
    cfg = ResampleConfig.from_profile("precise", (24, 40), out_shape=(36, 60))
    ops = rc.FusedOps(cfg, "cpu", variant="v1")
    before = dict(rp.launches)
    x = torch.from_numpy(_noise((3, 24, 40), seed=3))
    y = rp.phase_call(ops.phase, x)
    assert y.shape == (3, 36, 60) and y.dtype == torch.uint8
    assert rp.launches == before
    with pytest.raises(ValueError, match="expected"):
        rp.phase_call(ops.phase, x[:, :23])
    with pytest.raises(ValueError, match="call upscale_planar"):
        rc.fused_call(ops, x)
    with pytest.raises(ValueError, match="call phase_call"):
        rp.stream_v_call(ops.phase, x)


@pytest.mark.parametrize("kw,kernel", [
    ({"precision": "bf16"}, "phase_resample_bf16"),
    ({}, "phase_resample_fp32"),
])
def test_kernel_names_the_intermediate(kw, kernel):
    """bf16 with a rational horizontal axis holds the intermediate in bf16;
    a rational vertical axis over an integer horizontal one keeps it fp32."""
    cfg = ResampleConfig.from_profile("precise", (24, 40), out_shape=(36, 60), **kw)
    assert rc.FusedOps(cfg, "cpu", variant="v1").kernel == kernel
    flat = ResampleConfig.from_profile("precise", (24, 40), out_shape=(36, 40), **kw)
    assert rc.FusedOps(flat, "cpu", variant="v1").kernel == "phase_resample_fp32"
