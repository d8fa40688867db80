"""The ring kernel's interleaved form: (B, H, W, C) uint8 frames read and
written as they lie, so ``upscale_frames`` (and ``resample_2d_cuda`` around
it) launches no layout copy.

On the CPU (no JAX needed):

- the route as a pure function of the launch's geometry
  (``interleaved_block``, ``interleaved_plan``, ``ring_shape`` on the
  interleaved layout, and ``upload_layout``, which asks it once): the
  benchmark's 3/2 and 2/1 frames take it; rows that are not whole 16-byte
  chunks, unaligned tensors and bands too wide for one TMA box do not;
- the interleaved plan (blocks of their own width) gives the fused plan's
  bytes, linear and nonlinear, fp32 and bf16;
- a numpy re-enactment of the kernel's loops on its interleaved host layout
  (the band over rows of W·C bytes, the vertical pass down byte columns,
  the horizontal pass on column C·j + ch, the staged quarters of cb·C bytes
  and their TMA stores) gives the plain version's bytes;
- ``resample_2d_cuda`` on CPU tensors gives the planar route's bytes;
- with the library stubbed, ``upscale_frames`` launches the interleaved
  form with its channel count, counts it in ``resample_cuda.interleaved``,
  and declines (counting nothing) where the route does not apply; an
  ``Upscaler``'s card ops keep the route after ``fused_plan``'s cache has
  let their plan go; a streaming chunk and a sharded block (hand-built
  plans) reach the kernel through ``upscale_frames`` as planes.

On the card (marked ``cuda``; skipped without one,
``python -m pytest --noconftest tests/test_torch_interleaved.py``): the
interleaved ring identical bytes to the permute + planar route and to the
plain version at the benchmark's 3/2 frame and on the 2/1 plan, for 1, 3
and 4 channels, fp32 and bf16, dering and the quantized intermediate;
launches that must fall back equal too, with the counter unmoved; one
interleaved launch a call of ``lanczos_torch.upscale`` at the 3/2 frame.
"""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import _build  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from test_torch_fma import fma32  # noqa: E402

NONLINEAR = [{}, {"dering": True}, {"intermediate_quantize": True},
             {"dering": True, "intermediate_quantize": True}]


def _cfg(shape, scale=None, **kw):
    size = {"out_shape": kw.pop("out_shape")} if "out_shape" in kw else {"scale": scale}
    return lanczos_torch.ResampleConfig.from_profile("precise", shape, a=kw.pop("a", 3),
                                                     **size, **kw)


def _frames(n, shape, c, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n,) + tuple(shape) + (c,), dtype=np.uint8))


def _layout(cfg, c):
    plan = rc.interleaved_plan(cfg, rc.fused_plan(cfg).tile_out, c)
    return plan, rc.kernel_layout(plan, cfg.precision, c)


def _ints(lay):
    return {k: v for k, v in lay.items() if isinstance(v, int)}


def _planar_want(x, cfg, plan=None):
    """The plain version through planar layout: (B, H, W, C) → (B, OH, OW, C)."""
    b, c = x.shape[0], x.shape[3]
    planes = x.permute(0, 3, 1, 2).reshape(b * c, *x.shape[1:3]).contiguous()
    y = rc.fused_resample_reference(planes, plan or rc.fused_plan(cfg), cfg.precision,
                                    cfg.out_shape, cfg.dering, cfg.intermediate_quantize)
    return y.reshape(b, c, *cfg.out_shape).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the route, from the geometry alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row,ways", [(240, 1), (144, 1), (96, 2), (224, 2), (192, 4),
                                      (64, 4), (128, 8), (256, 8)])
def test_store_ways_counts_the_row_groups_on_one_bank(row, ways):
    """The eight row groups a warp writes, at ``row`` bytes apart, by brute
    force: the most whose four-bank runs start on one bank."""
    starts = [(g * row // 4) % 32 for g in range(8)]
    assert rc.store_ways(row) == ways == max(starts.count(b) for b in starts)


@pytest.mark.parametrize("channels,want", [(3, 80), (5, 48), (4, 48), (2, 112), (6, 16),
                                           (16, 16), (17, 0)])
def test_interleaved_block_is_the_widest_of_the_fewest_conflicts(channels, want):
    """Multiples of 16 with staged rows of at most 256 bytes: free of bank
    conflicts where an odd channel count allows it, else the fewest."""
    cb = rc.interleaved_block(channels)
    assert cb == want
    if cb:
        assert cb % 16 == 0 and cb * channels <= 256
        assert (rc.store_ways(cb * channels) == 1) == (channels % 2 == 1)


@pytest.mark.parametrize("shape,scale,kw,channels,pointers,want", [
    ((1440, 2560), (3, 2), {}, 3, (0, 256), True),  # quality4k-batch4-upscale's frames
    ((2160, 3840), (2, 1), {}, 3, (0, 256), True),  # perf8k-video-host's frames
    ((2160, 3840), (2, 1), {"precision": "bf16"}, 3, (0, 256), True),
    ((1440, 2560), (3, 2), {"dering": True, "intermediate_quantize": True}, 3, (0, 256), True),
    ((1080, 1920), (2, 1), {}, 4, (0, 512), True),
    ((96, 320), (3, 2), {}, 2, (0, 256), True),
    ((100, 300), (2, 1), {}, 3, (0, 256), False),  # W·C = 900: not whole 16-byte chunks
    ((64, 250), (2, 1), {}, 4, (0, 256), False),  # OW·C = 2000, W·C = 1000: no
    ((1440, 2560), (3, 2), {}, 3, (0, 8), False),  # an unaligned pointer
    ((128, 512), (1, 2), {}, 3, (0, 256), False),  # a band of 3 x 288 bytes: past a TMA box
])
def test_interleaved_route_rule(shape, scale, kw, channels, pointers, want):
    """Whether a launch takes the interleaved ring, from the plan's
    geometry, the channel count and the tensors' alignment alone."""
    cfg = _cfg(shape, scale, **kw)
    (_, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    plan, lay = _layout(cfg, channels)
    a = _ints(lay)
    assert a["channels"] == channels and plan.tile_out == rc.fused_plan(cfg).tile_out
    stages, blocks = rc.ring_shape(a, w, oh, ow, pointers, cfg.dering)
    assert (stages > 0) == want
    if max(pointers) % 16 == 0:  # host tables are aligned too: the layout's own route
        layout = rc.upload_layout(plan, cfg, "cpu", channels)
        assert (layout is not None) == want and (not want or layout.route == (stages, blocks))
    if want:
        assert 2 <= stages <= rc.RING_STAGES and blocks >= 1
        lay_r = rc.ring_layout(a, cfg.dering)
        limit = dict(rc.RING_BLOCKS)[blocks]
        assert lay_r["fixed"] + stages * lay_r["stage"] <= limit


def test_benchmark_frames_keep_the_planar_rings_blocks():
    """At the 3/2 and 2/1 frames the interleaved ring holds as many blocks
    an SM as the planar ring minus at most one (what the probe weighs)."""
    for shape, scale in (((1440, 2560), (3, 2)), ((2160, 3840), (2, 1))):
        cfg = _cfg(shape, scale)
        (_, w), (oh, ow) = cfg.in_shape, cfg.out_shape
        planar = _ints(rc.kernel_layout(rc.fused_plan(cfg), cfg.precision))
        _, lay = _layout(cfg, 3)
        p_blocks = rc.ring_shape(planar, w, oh, ow, (0,), False)[1]
        i_blocks = rc.ring_shape(_ints(lay), w, oh, ow, (0,), False)[1]
        assert p_blocks == 3 and i_blocks >= p_blocks - 1


def test_ring_layout_of_the_interleaved_form():
    """The launcher's sum for 80-column RGB blocks at 3/2, by hand: quarters
    of 16 rows of 240 bytes, aligned to 128; the intermediate's columns are
    bytes of 3 x kh."""
    cfg = _cfg((1440, 2560), (3, 2))
    plan, lay = _layout(cfg, 3)
    a = _ints(lay)
    assert plan.cb == 80 and a["mw"] == -(-(3 * plan.kh + 7) // 8) * 8
    assert a["bw"] >= a["mw"] + 8 and a["bw"] % 16 == 0 and a["bw"] <= 256
    quarter = -(-(16 * 240) // 128) * 128
    assert rc.ring_layout(a, False)["fixed"] == 1024 + 8 * quarter + 4 * a["mw"] * 64 + 80


# ---------------------------------------------------------------------------
# bytes on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", NONLINEAR)
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,channels", [
    ((40, 160), (3, 2), 3), ((36, 128), (2, 1), 3), ((30, 96), (2, 1), 4),
    ((24, 120), (4, 3), 4), ((20, 77), (2, 1), 3),
])
def test_interleaved_plan_gives_the_fused_plans_bytes(shape, scale, channels, precision, kw):
    """Blocks of another width, the same taps in the same order: the plain
    version on the interleaved plan equals it on the fused plan."""
    cfg = _cfg(shape, scale, precision=precision, **kw)
    plan = rc.interleaved_plan(cfg, rc.fused_plan(cfg).tile_out, channels)
    assert plan.cb == rc.interleaved_block(channels) != rc.fused_plan(cfg).cb
    x = _frames(2, shape, channels, seed=3)
    assert torch.equal(_planar_want(x, cfg, plan), _planar_want(x, cfg))


def _emulate_interleaved(x, lay, oh, ow, bf16, dering=False, quant=False):
    """The interleaved ring's loops in numpy, on its host layout: per (frame,
    row tile, column block), the uint8 band from the 16-byte boundary at or
    below byte C·starts_h[b] of the frame's rows of W·C bytes (zero past the
    image); the vertical pass over the intermediate's ``mw`` byte columns
    (from the 8-byte boundary at or below that byte), per group of four tile
    rows in step order, dering clamped to the band rows ``cv`` names,
    ``quant`` trunc-clipped, bf16 rounded; the horizontal pass, per group of
    four pixels and channel ch a sum over intermediate columns dj + C·(base_h
    + s) + ch, dering clamped to columns dj + C·ch[u] + ch; the trunc-clip
    into the staged tile, row r into row r >> 2 of quarter r & 3, pixel c's
    channel ch at byte C·c + ch of rows of cb·C bytes; each quarter out as a
    TMA box of ``tile / 4`` rows by cb·C bytes to output rows 4k + q, clipped
    at the edges."""
    nb, h, w, c = x.shape
    rows_in = x.reshape(nb, h, w * c)
    out = np.full((nb, oh, ow * c), 7, np.uint8)  # stores must cover every byte
    tile, tile_p, kv = lay["tile"], lay["tile_p"], lay["kv"]
    cb, cb_p, kh = lay["cb"], lay["cb_p"], lay["kh"]
    win_v, win_h, bw, mw = (lay[k] for k in ("win_v", "win_h", "bw", "mw"))
    rw = cb * c
    assert lay["channels"] == c and cb_p == cb and rw <= 256 and rw % 16 == 0
    assert bw >= mw + 8 and mw >= c * kh + 7 and bw % 16 == 0 and mw % 8 == 0
    quarter = -(-(tile_p // 4 * rw) // 128) * 128

    def clamp(v, a, b):
        return np.minimum(np.maximum(v, np.minimum(a, b)), np.maximum(a, b))

    def window_sum(a, wts):  # a (steps, m), wts (steps, 4) -> (m, 4), in step order, fmaf
        acc = np.zeros((a.shape[1], 4), np.float32)
        for s in range(a.shape[0]):
            acc = fma32(acc, wts[s][None, :], a[s][:, None])
        return acc

    for p in range(nb):
        for i in range(lay["num_tiles"]):
            for b in range(lay["n_cb"]):
                r0, c0 = int(lay["starts_v"][i]), c * int(lay["starts_h"][b])
                c_a, joff, dj = c0 & ~15, c0 & 8, c0 & 7
                band = np.zeros((kv, bw), np.uint8)
                rr = np.arange(kv)[:, None] + r0
                cc = np.arange(bw)[None, :] + c_a
                ok = (rr < h) & (cc < w * c)
                band[ok] = rows_in[p][np.minimum(rr, h - 1), np.minimum(cc, w * c - 1)][ok]
                bandf = band[:, joff : joff + mw].astype(np.float32)  # (kv, mw)
                midT = np.zeros((mw, tile_p), np.float32)
                for rg in range(tile_p // 4):
                    base = lay["base_v"][i, rg]
                    acc = window_sum(bandf[base : base + win_v], lay["wv"][i, :, rg])
                    if dering:
                        cv = lay["cv"][i][:, 4 * rg : 4 * rg + 4]
                        acc = clamp(acc, bandf[cv[0]].T, bandf[cv[1]].T)
                    midT[:, 4 * rg : 4 * rg + 4] = acc
                if quant:
                    midT = np.trunc(np.clip(midT, 0, 255))
                if bf16:
                    midT = torch.from_numpy(midT).bfloat16().float().numpy()
                u = lay["uniq_h"][b]
                quarters = np.zeros((4, quarter), np.uint8)
                r = np.arange(tile_p)
                for cg in range(cb_p // 4):
                    for ch in range(c):
                        cols = dj + c * (lay["base_h"][u, cg] + np.arange(win_h)) + ch
                        assert cols.max() < mw
                        acc = window_sum(midT[cols], lay["wh"][u, :, cg])
                        if dering:
                            cen = dj + c * lay["ch"][u][:, 4 * cg : 4 * cg + 4] + ch
                            acc = clamp(acc, midT[cen[0]].T, midT[cen[1]].T)
                        q = np.trunc(np.clip(acc, 0, 255)).astype(np.uint8)  # (tile_p, 4)
                        for e in range(4):
                            quarters[r & 3, (r >> 2) * rw + c * (4 * cg + e) + ch] = q[:, e]
                for qq in range(4):
                    for k in range(tile // 4):
                        row = 4 * (i * tile // 4 + k) + qq
                        n = min(rw, ow * c - b * rw)
                        if row < oh:
                            out[p, row, b * rw : b * rw + n] = quarters[qq, k * rw : k * rw + n]
    return out.reshape(nb, oh, ow, c)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,kw,channels", [
    ((40, 96), (3, 2), {}, 3),  # 80-pixel blocks: one whole, one ragged
    ((24, 64), (2, 1), {"align": "center"}, 3),
    ((32, 56), (2, 1), {"dering": True}, 4),  # 48-pixel blocks of RGBA, one ragged
    ((36, 48), (4, 3), {"dering": True, "intermediate_quantize": True}, 3),
    ((32, 128), (3, 2), {"intermediate_quantize": True}, 2),
])
def test_interleaved_kernel_reenacted(shape, scale, kw, channels, precision):
    """The kernel's interleaved loops, re-enacted on the host layout a
    launch uploads: identical bytes to the plain version."""
    cfg = _cfg(shape, scale, precision=precision, **kw)
    (_, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    plan, lay = _layout(cfg, channels)
    assert rc.ring_shape(_ints(lay), w, oh, ow, (0,), cfg.dering)[0] > 0
    x = _frames(1, shape, channels, seed=5)
    got = _emulate_interleaved(x.numpy(), lay, oh, ow, precision == "bf16", cfg.dering,
                               cfg.intermediate_quantize)
    np.testing.assert_array_equal(got, _planar_want(x, cfg).numpy())


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("shape,scale", [((24, 32), (3, 2)), ((20, 48), (2, 1)), ((13, 21), (2, 1))])
def test_resample_2d_cuda_on_the_cpu_is_the_planar_route(shape, scale, channels):
    """On CPU tensors the interleaved API keeps its planar route: the plain
    version's bytes, through the batch's leading axes."""
    cfg = _cfg(shape, scale)
    ops = rc.FusedOps(cfg, "cpu")
    assert ops.layout(channels) is None
    x = _frames(4, shape, channels, seed=channels)
    before = dict(rc.interleaved)
    got = rc.resample_2d_cuda(x.reshape(2, 2, *x.shape[1:]), ops)
    assert got.shape == (2, 2) + tuple(cfg.out_shape) + (channels,)
    assert torch.equal(got.reshape(4, *got.shape[2:]), _planar_want(x, cfg))
    assert rc.interleaved == before


# ---------------------------------------------------------------------------
# the launch, with the library stubbed
# ---------------------------------------------------------------------------


class _Library:
    """The kernels' library with the launch stubbed: it records each
    launch's ``(channels, stages, blocks)`` and writes nothing."""

    def __init__(self):
        self.launched = []

    def lanczos_fused_resample(self, *args):
        self.launched.append(args[-4:-1])
        return 0


@pytest.fixture
def stubbed(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("launches", "pipelined", "interleaved"):  # from zero, whatever ran before
        monkeypatch.setattr(rc, name, dict.fromkeys(getattr(rc, name), 0))
    return lib


def _as_on_a_card(ops):
    """``ops`` (built on the CPU) holding what a card's would: the planar
    layout, uploaded to the CPU by ``upload_layout`` as a card's are; the interleaved
    ones then come from :meth:`FusedOps.layout` as on a card."""
    ops.layouts[1] = rc.upload_layout(ops.plan, ops.cfg, "cpu")
    return ops


def _ops_as_on_a_card(cfg):
    return _as_on_a_card(rc.FusedOps(cfg, "cpu"))


@pytest.mark.parametrize("shape,scale,kw,channels", [
    ((32, 32), (3, 2), {}, 3),
    ((16, 32), (2, 1), {"precision": "bf16", "dering": True}, 4),
    ((16, 64), (2, 1), {"intermediate_quantize": True}, 2),
])
def test_interleaved_call_launches_the_interleaved_form(stubbed, shape, scale, kw, channels):
    cfg = _cfg(shape, scale, **kw)
    ops = _ops_as_on_a_card(cfg)
    x = _frames(2, shape, channels)
    y = rc.resample_2d_cuda(x, ops)
    assert y.shape == (2,) + tuple(cfg.out_shape) + (channels,) and y.is_contiguous()
    assert len(stubbed.launched) == 1 and stubbed.launched[0][0] == channels
    assert stubbed.launched[0][1] >= 2  # the ring, with a ring of two stages or more
    assert rc.interleaved[ops.kernel] == rc.launches[ops.kernel] == 1
    assert rc.pipelined[ops.kernel] == 1


@pytest.mark.parametrize("case", ["one channel", "ragged rows", "unaligned", "strided"])
def test_interleaved_call_declines_and_counts_nothing(stubbed, case):
    """Launches that fall back go through planar layout (on the CPU the
    plain version: no launch), ``interleaved`` unmoved."""
    shape = (16, 30) if case == "ragged rows" else (16, 32)  # W·C = 90
    cfg = _cfg(shape, (2, 1))
    ops = _ops_as_on_a_card(cfg)
    c = 1 if case == "one channel" else 3
    x = _frames(2, shape, c)
    if case == "unaligned":
        buf = torch.zeros(x.numel() + 1, dtype=torch.uint8)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    if case == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert (ops.layout(c) is None) == (case == "ragged rows")  # else the frames decline
    assert torch.equal(rc.resample_2d_cuda(x, ops), _planar_want(x, cfg))
    assert stubbed.launched == [] and rc.interleaved[ops.kernel] == 0


def test_interleaved_layout_declines_what_the_route_does_not_take(monkeypatch):
    """The CPU, a plan handed in (hand-built, or even the config's own) and
    a width-first nonlinear config (the transposed image) have no
    interleaved layout, and one channel has the planar one; a plan-less
    ``FusedOps`` on a card has one."""
    monkeypatch.setattr(rc, "upload_layout", lambda plan, cfg, device, channels=1: (
        "tables", plan.tile_out, plan.cb, channels))

    def as_on_a_card(ops):  # the planar layout where a card's ops upload it
        on = ops.tr_ops or ops
        on.layouts[1] = rc.upload_layout(on.plan, on.cfg, on.device)
        return ops

    cfg = _cfg((16, 32), (2, 1))
    assert rc.FusedOps(cfg, "cpu").layout(3) is None
    own = as_on_a_card(rc.FusedOps(cfg, "cpu"))
    assert own.layout(1) == ("tables", own.plan.tile_out, own.plan.cb, 1)
    assert own.layout(3) == ("tables", own.plan.tile_out, 80, 3)
    handed = as_on_a_card(rc.FusedOps(cfg, "cpu", plan=rc.fused_plan(cfg)))
    assert handed.layout(3) is None
    hand = as_on_a_card(rc.FusedOps(cfg, "cpu", plan=rc.plan_at(cfg, 16, 32)))
    assert hand.layout(3) is None
    wf = as_on_a_card(rc.FusedOps(_cfg((16, 32), (2, 1), dering=True, order="width_first"),
                                  "cpu"))
    assert wf.tr_ops is not None and wf.layout(3) is None


def test_an_upscalers_card_ops_keep_the_route_once_the_plan_cache_lets_go(stubbed):
    """A card's ops, built as ``Upscaler`` builds them, own their plan as a
    fact: with ``fused_plan``'s cache cleared and nine other configs planned
    since (their plan is no longer the cache's), the first RGB frames still
    take the interleaved ring, in one launch."""
    cfg = _cfg((16, 32), (2, 1))
    ops = _as_on_a_card(lanczos_torch.Upscaler(cfg, device="cpu")._make(torch.device("cpu")))
    rc.fused_plan.cache_clear()
    for w in range(48, 48 + 9 * 16, 16):
        rc.fused_plan(_cfg((16, w), (2, 1)))
    assert rc.fused_plan(cfg) is not ops.plan
    assert ops.layout(3) is not None and ops.layout(3).args["cb"] == 80
    y = rc.upscale_frames(_frames(2, (16, 32), 3), ops)
    assert y.shape == (2, 32, 64, 3)
    assert [launch[0] for launch in stubbed.launched] == [3]
    assert rc.interleaved[ops.kernel] == rc.launches[ops.kernel] == 1


def _card_tables(wv):
    """A shard's :class:`VerticalTables` holding what a card's would: its
    kernel tables, on the CPU."""
    lay = rc.vertical_layout(wv.plan, wv.precision)
    return rc.VerticalTables(wv.plan, wv.precision, wv.fields, {
        k: torch.from_numpy(v) for k, v in lay.items() if isinstance(v, np.ndarray)}, True)


@pytest.mark.parametrize("path", ["streaming", "sharded"])
def test_hand_built_plans_reach_the_kernel_through_upscale_frames(path, stubbed, monkeypatch):
    """A streaming fused chunk and a sharded ``backend="mxu"`` block reach
    the kernel through ``upscale_frames``, which sends their RGB frames
    through planar layout even on a card (their plans are hand-built): each
    launch takes one channel on the planar layout's route, the one
    ``ring_shape`` gives the plan's geometry, as before the frames
    function; the plain version's bytes come back.  No module of
    ``models/`` or ``parallel/`` calls ``fused_call`` itself."""
    from pathlib import Path

    from lanczos_torch.models import streaming
    from lanczos_torch.parallel import sharded
    from lanczos_torch.parallel.mesh import Mesh

    real_call, real_frames, seen = rc.fused_call, rc.upscale_frames, []

    def on_a_card(ops, x, wv=None):  # the launch a card makes, then the plain version
        out = torch.empty((x.shape[0], *ops.cfg.out_shape), dtype=torch.uint8)
        rc._launch(ops, x, out, ops.layout(), wv and _card_tables(wv))
        return real_call(ops, x, wv)

    def spy(frames, ops, wv=None):
        seen.append(ops)
        return real_frames(frames, ops, wv)

    cfg = _cfg((64, 48), out_shape=(128, 96))
    x = _frames(2, (64, 48), 3, seed=6)
    if path == "streaming":
        x = x[0]
        model = lanczos_torch.StreamingUpscaler(cfg, 32, chunk_backend="mxu", device="cpu")
        ops = _as_on_a_card(model._mxu)
    else:
        model = sharded.ShardedUpscaler(cfg, Mesh.local(["cpu"] * 2, (1, 2)), backend="mxu")
        ops = _as_on_a_card(model._tables(torch.device("cpu")).fused)
    want = lanczos_torch.Upscaler(cfg, device="cpu")(x)
    monkeypatch.setattr(rc, "fused_call", on_a_card)
    monkeypatch.setattr(streaming if path == "streaming" else sharded, "upscale_frames", spy)
    got = torch.as_tensor(model(x.numpy() if path == "streaming" else x))
    assert seen and all(o is ops for o in seen) and ops.layout(3) is None
    (_, w), (oh, ow) = ops.cfg.in_shape, ops.cfg.out_shape
    route = rc.ring_shape(ops.layout().args, w, oh, ow, (0,), cfg.dering)
    assert route[0] > 0
    assert stubbed.launched == [(1,) + route] * len(seen)
    assert rc.interleaved[ops.kernel] == 0 and rc.launches[ops.kernel] == len(seen)
    if path == "streaming":  # within 1 LSB: edge rows come from a padded window
        assert (got.int() - want.int()).abs().max() <= 1
    else:
        assert torch.equal(got, want)
    root = Path(rc.__file__).parents[1]
    for module in [*(root / "models").glob("*.py"), *(root / "parallel").glob("*.py")]:
        assert "fused_call(" not in module.read_text(), module.name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _route(ops, x):
    """``resample_2d_cuda`` on the card, synchronised: its output and the
    interleaved launches it made."""
    before = rc.interleaved[ops.kernel]
    y = rc.resample_2d_cuda(x, ops)
    torch.cuda.synchronize()
    return y, rc.interleaved[ops.kernel] - before


@pytest.mark.cuda
@pytest.mark.parametrize("channels,precision,kw", [
    (3, "fp32", {}), (3, "bf16", {}), (4, "fp32", {}), (1, "fp32", {}),
    (3, "fp32", {"dering": True, "intermediate_quantize": True}), (4, "bf16", {"dering": True}),
])
def test_interleaved_ring_at_the_benchmark_frame(cuda, channels, precision, kw):
    """quality4k-batch4-upscale's batch (4 x 1440x2560 -> 3840x2160): one
    interleaved launch a call (none for one channel), identical bytes to
    the permute + planar route and to the plain version; ``upscale`` takes
    the same route."""
    cfg = _cfg((1440, 2560), out_shape=(2160, 3840), precision=precision, **kw)
    ops = rc.FusedOps(cfg, cuda)
    x = _frames(4, (1440, 2560), channels, seed=11).to(cuda)
    got, n = _route(ops, x)
    assert n == (channels > 1) and got.is_contiguous()
    planar = rc.upscale_planar(x.permute(0, 3, 1, 2), ops).permute(0, 2, 3, 1)
    assert torch.equal(got, planar)
    assert torch.equal(got, _planar_want(x, cfg))
    before = rc.interleaved[ops.kernel]
    y = lanczos_torch.upscale(x, out_shape=(2160, 3840), precision=precision, **kw)
    torch.cuda.synchronize()
    assert rc.interleaved[ops.kernel] == before + (channels > 1) and torch.equal(y, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", NONLINEAR)
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,scale,channels", [
    ((96, 320), (3, 2), 3), ((96, 320), (3, 2), 4), ((96, 320), (3, 2), 1),
    ((64, 256), (2, 1), 3), ((64, 256), (2, 1), 4), ((64, 256), (2, 1), 1),
    ((136, 480), (2, 1), 3),  # 3 row tiles, a ragged last one; 12 column blocks
])
def test_interleaved_ring_matches_planar_and_plain(cuda, shape, scale, channels, precision, kw):
    cfg = _cfg(shape, scale, precision=precision, **kw)
    ops = rc.FusedOps(cfg, cuda)
    x = _frames(2, shape, channels, seed=channels).to(cuda)
    got, n = _route(ops, x)
    assert n == (channels > 1)
    planar = rc.upscale_planar(x.permute(0, 3, 1, 2), ops).permute(0, 2, 3, 1)
    assert torch.equal(got, planar)
    assert torch.equal(got, _planar_want(x, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("precision,kw", [
    ("fp32", {}), ("bf16", {}), ("fp32", {"dering": True, "intermediate_quantize": True}),
])
@pytest.mark.parametrize("shape,scale,tile,channels", [
    ((48, 160), (3, 2), 16, 3),  # tile_p 16: 4 row groups, 23 column groups
    ((48, 160), (3, 2), 16, 4),  # 20 column groups
    ((64, 256), (2, 1), 128, 3),  # tile_p 128: 32 row groups, lanes swapped
    ((64, 256), (2, 1), 64, 4),  # 16 row groups of 16 column groups
])
def test_interleaved_ring_on_other_row_tiles(cuda, shape, scale, tile, channels, precision, kw):
    """The vertical pass's thread tiles on interleaved intermediates of
    other widths and row tiles: identical bytes to the plain version."""
    cfg = _cfg(shape, scale, precision=precision, **kw)
    ops = rc.FusedOps(cfg, cuda)
    layout = rc.upload_layout(rc.interleaved_plan(cfg, tile, channels), cfg, cuda, channels)
    assert layout is not None  # the ring takes it
    ops.layouts[channels] = layout
    x = _frames(2, shape, channels, seed=tile).to(cuda)
    got, n = _route(ops, x)
    assert n == 1
    assert torch.equal(got, _planar_want(x, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged rows", "unaligned", "width first"])
def test_fallbacks_match_and_count_nothing(cuda, case):
    kw = {"dering": True, "order": "width_first"} if case == "width first" else {}
    shape = (48, 100) if case == "ragged rows" else (48, 128)  # W·C = 300
    cfg = _cfg(shape, (2, 1), **kw)
    ops = rc.FusedOps(cfg, cuda)
    x = _frames(2, shape, 3, seed=9).to(cuda)
    if case == "unaligned":
        buf = torch.zeros(x.numel() + 1, dtype=torch.uint8, device=cuda)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    got, n = _route(ops, x)
    assert n == 0
    want = lanczos_torch.Upscaler(cfg, device="cpu")(x.cpu())
    assert torch.equal(got.cpu(), want)
