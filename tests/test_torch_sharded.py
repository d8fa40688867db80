"""``lanczos_torch.ShardedUpscaler`` on the CPU (a ``Mesh.local`` of 8 CPU
positions) against the port's own single-device result and against
``lanczos_tpu``'s ``ShardedUpscaler`` on ``jax.make_mesh``, on the same
seeded inputs, at the shapes of ``tests/test_sharded.py``.

Limits: every sharded path identical bytes to the port's single-device
result of the same path (gather and shift to ``backend="xla"``, the fused
path's plain version to ``Upscaler(cfg)``, ``hls`` and ``c_oracle`` to
their own single-device paths), overlap identical to the serial exchange;
against the JAX sharded result the port's contract: ``hls`` and
``c_oracle`` identical bytes, fp32 ≤ 1 LSB on ≤ 1% of pixels, the port's
bf16 ≤ 3 LSB on ≤ 50% of the JAX fp32 result.  The scales, edge modes
and ``c_oracle`` cases are in ``test_torch_sharded_paths.py``, the fused
cases against the JAX fused overlay in ``test_torch_sharded_fused.py``
(each JAX mesh program compiles for seconds; three files spread them over
the test workers).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402
from lanczos_tpu.parallel.sharded import ShardedUpscaler as TpuSharded  # noqa: E402
from lanczos_tpu.parallel.sharded import choose_mesh_shape as tpu_choose  # noqa: E402
from lanczos_tpu.parallel.sharded import halo_exchange_rows as tpu_exchange  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.ops import resample_cuda as rc  # noqa: E402
from lanczos_torch.parallel import mesh as pm  # noqa: E402
from lanczos_torch.parallel import sharded as ps  # noqa: E402
from lanczos_torch.parallel.mesh import Mesh  # noqa: E402
from lanczos_torch.parallel.sharded import ShardedUpscaler, choose_mesh_shape  # noqa: E402

LIMITS = {"fp32": (1, 0.01), "bf16": (3, 0.50)}


def _mesh(shape):
    return Mesh.local(["cpu"] * (shape[0] * shape[1]), shape)


def _cfgs(profile, ins, **kw):
    return (lanczos_torch.ResampleConfig.from_profile(profile, ins, **kw),
            lanczos_tpu.ResampleConfig.from_profile(
                profile, ins, **{k: v for k, v in kw.items() if k != "precision"}))


def _img(b, h, w, seed=42, dtype=np.uint8):
    hi = 256 if dtype == np.uint8 else 65536
    return np.random.default_rng(seed).integers(0, hi, size=(b, h, w, 3), dtype=dtype)


def _within(got, want, precision):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    lim, frac_lim = LIMITS[precision]
    assert d.max() <= lim and (d > 0).mean() <= frac_lim, (d.max(), (d > 0).mean())


def _single(cfg, img, backend="xla"):
    return lanczos_torch.Upscaler(cfg, backend=backend, device="cpu")(torch.from_numpy(img))


@functools.lru_cache(maxsize=None)
def _jax_mesh(shape):
    return jax.make_mesh(shape, ("data", "rows"))


def _tpu(tcfg, shape, img, **kw):
    return np.asarray(TpuSharded(tcfg, _jax_mesh(shape), **kw)(img))


def _check_float(profile, ins, mesh_shape, img, precision="fp32", **kw):
    """The gather/shift path byte-equal to the port's single-device gather,
    within the contract of the JAX sharded result; returns the model."""
    cfg, tcfg = _cfgs(profile, ins, precision=precision, **kw)
    sh = ShardedUpscaler(cfg, _mesh(mesh_shape), backend="gather")
    got = sh(torch.from_numpy(img))
    assert torch.equal(got, _single(cfg, img))
    _within(got.numpy(), _tpu(tcfg, mesh_shape, img), precision)
    return sh


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_single_device(mesh_shape):
    img = _img(mesh_shape[0], 32, 24)
    sh = _check_float("precise", (32, 24), mesh_shape, img, scale=(2, 1), a=2)
    assert sh.use_shift and not sh.use_mxu
    # "auto" takes the fused kernel's plain version, equal to the single device's
    cfg, _ = _cfgs("precise", (32, 24), scale=(2, 1), a=2)
    auto = ShardedUpscaler(cfg, _mesh(mesh_shape))
    assert auto.use_mxu
    assert torch.equal(auto(img), _single(cfg, img, "auto"))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("ins,kw", [
    ((32, 16), dict(scale=(2, 1), a=2, dering=True)),
    ((64, 32), dict(scale=(1, 2), a=3)),  # downscale: an a·D/N-row halo
    ((32, 16), dict(scale=(2, 1), a=2, order="width_first", intermediate_quantize=True,
                    normalize=False, edge_mode="drop")),
])
def test_sharded_dering_downscale_width_first(ins, kw, precision):
    _check_float("precise", ins, (1, 4), _img(1, *ins), precision, **kw)


def test_sharded_fixed_point_hls():
    """hls over rows: identical to the single-device fixed path, to the JAX
    sharded path and to the stream simulator."""
    from lanczos_torch.ref.hls_sim import hls_stream_upscale

    cfg, tcfg = _cfgs("hls", (32, 16), scale=(2, 1), a=2)
    img = _img(1, 32, 16)
    sh = ShardedUpscaler(cfg, _mesh((1, 4)))
    assert not sh.use_mxu and sh.halo >= 2
    out = sh(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, _single(cfg, img, "auto").numpy())
    np.testing.assert_array_equal(out, _tpu(tcfg, (1, 4), img))
    np.testing.assert_array_equal(out[0], hls_stream_upscale(img[0], 64, 32, a=2,
                                                             bit_precision=cfg.bit_precision))


def test_choose_mesh_shape():
    for n in range(1, 17):
        assert choose_mesh_shape(n) == tpu_choose(n)
        d, r = choose_mesh_shape(n)
        assert d * r == n
    assert choose_mesh_shape(8) == (2, 4)


@pytest.mark.parametrize("profile,ins,kw,mesh_shape,match", [
    ("precise", (64, 32), dict(scale=(1, 4), a=3), (1, 8), "shards along the rows axis"),
    ("c_oracle", (8, 16), dict(scale=(2, 1), a=3), (1, 8), "rows per shard; use fewer"),
    ("hls", (8, 16), dict(scale=(2, 1), a=2), (1, 8), "use fewer shards or a larger"),
])
def test_use_fewer_shards_refusals(profile, ins, kw, mesh_shape, match):
    """A halo larger than a shard raises before anything runs, as in the
    reference (a silently wrong gather otherwise)."""
    cfg, tcfg = _cfgs(profile, ins, **kw)
    with pytest.raises(ValueError, match="use fewer shards") as want:
        TpuSharded(tcfg, _jax_mesh(mesh_shape))
    with pytest.raises(ValueError, match=match) as got:
        ShardedUpscaler(cfg, _mesh(mesh_shape))
    assert str(got.value) == str(want.value)


def test_sharded_refusals():
    cfg, _ = _cfgs("precise", (32, 24), scale=(2, 1), a=2)
    with pytest.raises(ValueError, match="must divide rows axis size 3"):
        ShardedUpscaler(cfg, Mesh.local(["cpu"] * 3, (1, 3)))
    with pytest.raises(ValueError, match="unknown sharded backend"):
        ShardedUpscaler(cfg, _mesh((1, 4)), backend="xla")
    with pytest.raises(TypeError, match="Mesh"):
        ShardedUpscaler(cfg, object())
    with pytest.raises(ValueError, match="no axis 'rows'"):
        ShardedUpscaler(cfg, Mesh.local(["cpu"] * 4, (4,), ("data",)))
    sh = ShardedUpscaler(cfg, _mesh((2, 4)))
    with pytest.raises(ValueError, match="data axis size 2"):
        sh(_img(3, 32, 24))
    with pytest.raises(ValueError, match="expected"):
        sh(_img(2, 32, 24)[0])
    with pytest.raises(TypeError, match="uint8 frames"):
        ShardedUpscaler(cfg, _mesh((2, 4)), backend="mxu")(_img(2, 32, 24).astype(np.float32))
    with pytest.raises(ValueError, match="uint16 input"):
        hls, _ = _cfgs("hls", (32, 24), scale=(2, 1), a=2)
        ShardedUpscaler(hls, _mesh((2, 4)))(_img(2, 32, 24, dtype=np.uint16))


@pytest.mark.parametrize("profile,kw", [
    ("hls", dict(scale=(2, 1), a=2)),
    ("c_oracle", dict(scale=(2, 1), a=2)),
    ("precise", dict(scale=(2, 1), a=3, dering=True, order="width_first")),
    ("precise", dict(scale=(2, 1), a=3, intermediate_quantize=True, order="width_first")),
])
def test_sharded_mxu_gate(profile, kw):
    """Configs the fused overlay cannot take raise under backend="mxu" (the
    bit-exact profiles, width-first nonlinearities), as the reference's do,
    and run their own path under "auto"."""
    cfg, tcfg = _cfgs(profile, (64, 48), **kw)
    with pytest.raises(NotImplementedError):
        TpuSharded(tcfg, _jax_mesh((1, 4)), backend="mxu")
    with pytest.raises(NotImplementedError, match="sharded fused path"):
        ShardedUpscaler(cfg, _mesh((1, 4)), backend="mxu")
    assert not ShardedUpscaler(cfg, _mesh((1, 4))).use_mxu


# ------------------------------------------- halo-overlap structure


@pytest.mark.parametrize(
    "kw",
    [
        dict(scale=(2, 1), a=2),
        dict(scale=(3, 2), a=3),
        dict(scale=(7, 3), a=3),
        dict(scale=(2, 1), a=3, dering=True),
        dict(scale=(1, 2), a=2),  # downscale: halo from d > n
    ],
)
def test_gather_overlap_bit_identical_to_serial_exchange(kw):
    n, d = kw["scale"]
    h = 48 if d == 3 else (128 if n < d else 64)
    cfg, tcfg = _cfgs("precise", (h, 24), **kw)
    img = torch.from_numpy(_img(2, h, 24))
    a = ShardedUpscaler(cfg, _mesh((2, 4)), backend="gather")
    b = ShardedUpscaler(cfg, _mesh((2, 4)), backend="gather", overlap=False)
    assert torch.equal(a(img), b(img))
    assert torch.equal(a(img), _single(cfg, img.numpy()))
    t = TpuSharded(tcfg, _jax_mesh((2, 4)), backend="gather")
    split = (a.b_top, a.b_bot, a.wtop, a.wbot) if a.b_top >= 0 else (a.b_top,)
    assert split == ((t.b_top, t.b_bot, t.wtop, t.wbot) if t.b_top >= 0 else (t.b_top,))
    assert a.use_shift == t.use_shift


@pytest.mark.parametrize("kw", [
    dict(scale=(2, 1), a=3),
    dict(scale=(3, 2), a=3, edge_mode="drop"),
    dict(scale=(1, 2), a=2),
    dict(scale=(2, 1), a=2, order="width_first"),
])
def test_gather_overlap_split_bounds_equal_the_reference(kw):
    """b_top, b_bot, wtop, wbot as the JAX model computes them; the split is
    available and small at 2/1."""
    cfg, tcfg = _cfgs("precise", (128, 16), **kw)
    m = ShardedUpscaler(cfg, _mesh((1, 4)), backend="gather")
    t = TpuSharded(tcfg, _jax_mesh((1, 4)), backend="gather")
    assert (m.b_top, m.halo, m.in_h_local, m.out_h_local) == (
        t.b_top, t.halo, t.in_h_local, t.out_h_local)
    if t.b_top >= 0:
        assert (m.b_bot, m.wtop, m.wbot) == (t.b_bot, t.wtop, t.wbot)
    if kw == dict(scale=(2, 1), a=3):
        assert m.b_top >= 0 and m.b_top + m.b_bot < m.out_h_local // 2
        assert 1 <= m.wtop <= m.in_h_local and 1 <= m.wbot <= m.in_h_local


@pytest.mark.parametrize("profile,kw", [
    ("precise", dict(scale=(2, 1), a=3)),
    ("precise", dict(scale=(1, 2), a=3)),
    ("precise", dict(scale=(2, 1), a=3, order="width_first")),
    ("precise", dict(scale=(2, 1), a=3, edge_mode="drop")),
    ("hls", dict(scale=(2, 1), a=2)),
    ("c_oracle", dict(scale=(2, 1), a=3)),
])
def test_halo_spec_equals_the_reference(profile, kw):
    cfg, tcfg = _cfgs(profile, (64, 48), **kw)
    m = ShardedUpscaler(cfg, _mesh((1, 4)))
    t = TpuSharded(tcfg, _jax_mesh((1, 4)), backend="mxu" if m.use_mxu else "auto")
    assert m.use_mxu == t.use_mxu
    for args in ((3, True), (3, False), (1, True)):
        assert m.halo_spec(*args) == t.halo_spec(*args)


def test_shift_channel_groups_bit_identical():
    cfg, _ = _cfgs("precise", (64, 32), scale=(2, 1), a=3)
    img = torch.from_numpy(_img(2, 64, 32))
    a = ShardedUpscaler(cfg, _mesh((2, 4)), backend="gather")
    b = ShardedUpscaler(cfg, _mesh((2, 4)), backend="gather", overlap=False)
    assert a.use_shift and torch.equal(a(img), b(img))


def test_sharded_uint16_contract():
    """uint16 frames: the float path, then the trunc-clip against 65535."""
    cfg, tcfg = _cfgs("precise", (32, 24), scale=(2, 1), a=2)
    img16 = _img(2, 32, 24, dtype=np.uint16)
    out = ShardedUpscaler(cfg, _mesh((2, 4)))(torch.from_numpy(img16))
    assert out.dtype == torch.uint16
    assert torch.equal(out, _single(cfg, img16))
    _within(out.numpy(), _tpu(tcfg, (2, 4), img16), "fp32")


def test_upscale_one_shot_mesh():
    """upscale(..., mesh=) routes through ShardedUpscaler."""
    cfg, tcfg = _cfgs("precise", (32, 24), scale=(2, 1), a=2)
    img = _img(2, 32, 24)
    out = lanczos_torch.upscale(torch.from_numpy(img), scale=(2, 1), a=2, mesh=_mesh((2, 4)))
    assert torch.equal(out, _single(cfg, img, "auto"))
    g = lanczos_torch.upscale(img, scale=(2, 1), a=2, mesh=_mesh((2, 4)), backend="gather")
    assert torch.equal(g, _single(cfg, img))
    want = np.asarray(lanczos_tpu.upscale(img, scale=(2, 1), a=2, mesh=_jax_mesh((2, 4))))
    _within(g.numpy(), want, "fp32")


# ------------------------------------------- the halo exchange


def test_halo_exchange_equals_the_reference():
    """The (top, bot) strips, wrap-around rows of the edge shards included,
    as the reference's ppermutes give them."""
    img = _img(2, 32, 8)
    mesh = _mesh((2, 4))
    blocks = {p: torch.from_numpy(img[p[0] : p[0] + 1, p[1] * 8 : (p[1] + 1) * 8].copy())
              for p in mesh.positions()}
    ext = pm.halo_exchange_rows(mesh, blocks, 3, "rows", axis=1)
    fn = jax.jit(jax.shard_map(
        lambda x: tpu_exchange(x, 3, "rows", axis=1), mesh=_jax_mesh((2, 4)),
        in_specs=jax.sharding.PartitionSpec("data", "rows"),
        out_specs=jax.sharding.PartitionSpec("data", "rows")))
    want = np.asarray(fn(img))  # (2, 4 · (8 + 6), 8, 3)
    for (d, r), got in ext.items():
        np.testing.assert_array_equal(got.numpy(), want[d : d + 1, r * 14 : (r + 1) * 14])
    zero = pm.halo_exchange_rows(Mesh.local(["cpu"] * 2, (2, 1)),
                                 {(0, 0): blocks[(0, 0)], (1, 0): blocks[(1, 0)]}, 3)
    assert not zero[(0, 0)][:, :3].any() and not zero[(0, 0)][:, -3:].any()


def _sentinel_permutes(real):
    """halo_permutes whose wrap-around strips (the first position's top,
    the last's bottom on the rows axis) hold 255."""
    def permutes(mesh, blocks, halo, axis_name="rows", axis=1):
        strips, wait = real(mesh, blocks, halo, axis_name, axis)
        k, n = mesh.axis(axis_name), mesh.shape[axis_name]
        out = {}
        for p, (top, bot) in strips.items():
            if p[k] == 0:
                top = torch.full_like(top, 255)
            if p[k] == n - 1:
                bot = torch.full_like(bot, 255)
            out[p] = (top, bot)
        return out, wait
    return permutes


@pytest.mark.parametrize("profile,kw,backend,overlap", [
    ("precise", dict(scale=(2, 1), a=3, edge_mode="drop"), "gather", True),
    ("precise", dict(scale=(2, 1), a=3, edge_mode="drop"), "gather", False),
    ("precise", dict(scale=(2, 1), a=3), "gather", True),  # shift: edge pads replace them
    ("precise", dict(scale=(3, 2), a=3, dering=True), "auto", True),  # fused
    ("hls", dict(scale=(2, 1), a=2), "auto", True),
    ("c_oracle", dict(scale=(2, 1), a=3), "auto", True),
])
def test_wraparound_halo_rows_are_never_read(monkeypatch, profile, kw, backend, overlap):
    cfg, _ = _cfgs(profile, (48, 32), **kw)
    img = torch.from_numpy(_img(1, 48, 32, seed=3))
    want = ShardedUpscaler(cfg, _mesh((1, 4)), backend=backend, overlap=overlap)(img)
    monkeypatch.setattr(pm, "halo_permutes", _sentinel_permutes(pm.halo_permutes))
    monkeypatch.setattr(ps, "halo_permutes", pm.halo_permutes)
    got = ShardedUpscaler(cfg, _mesh((1, 4)), backend=backend, overlap=overlap)(img)
    assert torch.equal(got, want)
    assert torch.equal(got, _single(cfg, img.numpy(), "auto" if backend == "auto" else "xla"))


# ------------------------------------------- the fused path's per-shard tables


@pytest.mark.parametrize("kw", [dict(), dict(precision="bf16"),
                                dict(precision="bf16", dering=True),
                                dict(precision="bf16", align="center")])
def test_shard_plans_carry_the_frame_rows_at_4k(kw):
    """At 4K→8K on 2, 4 and 8 row shards, every output row's vertical
    weights (in the kernel's precision, in tap order) and the horizontal
    tables equal the whole-frame plan's: the kernel sums the same nonzero
    terms in the same order, so the bytes are the single-device kernel's.
    Host-side only (no image)."""
    cfg = lanczos_torch.ResampleConfig.from_profile(
        "precise", (2160, 3840), scale=(2, 1), a=3, **kw)
    whole = rc.fused_plan(cfg)

    def rows(plan, n):
        w = rc._kernel_weights(plan.wv, 2, cfg.precision).reshape(-1, plan.kv)[:n]
        return [tuple(r[r != 0]) for r in w]

    want = rows(whole, 4320)
    for R in (2, 4, 8):
        sh = ShardedUpscaler(cfg, _mesh((1, R)), backend="mxu")
        assert len({(p.kv, p.win_v, p.num_tiles) for p in sh._plans}) == 1
        assert sum((rows(p, sh.out_h_local) for p in sh._plans), []) == want
        assert sh._plans[0].cb == whole.cb
        np.testing.assert_array_equal(rc._kernel_weights(sh._plans[0].wh, 1, cfg.precision),
                                      rc._kernel_weights(whole.wh, 1, cfg.precision))


def test_vertical_table_refusals_name_the_field():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (64, 48), scale=(2, 1), a=3,
                                                    dering=True)
    sh = ShardedUpscaler(cfg, _mesh((1, 4)), backend="mxu")
    t = sh._tables(torch.device("cpu"))
    x = torch.from_numpy(_img(1, 22, 48)[0].transpose(2, 0, 1).copy())
    y = rc.fused_call(t.fused, x, wv=t.wv[1])
    assert y.shape == (3, 32, 96)
    p = sh._plans[1]
    prec = cfg.precision
    taller = rc.build_fused_plan(sh._syn, p.tile_out, *_shard_op(sh, 1), kv=p.kv + 1)
    bad = {
        "kv": taller,
        "win_v": dataclasses.replace(p, win_v=p.win_v + 1),
        "num_tiles": dataclasses.replace(p, num_tiles=2, wv=np.concatenate([p.wv, p.wv]),
                                         starts_v=np.concatenate([p.starts_v] * 2),
                                         center_v=np.concatenate([p.center_v] * 2)),
    }
    for field, plan in bad.items():
        with pytest.raises(ValueError, match=f"have {field}="):
            rc.fused_call(t.fused, x, wv=rc.vertical_tables(plan, prec, "cpu"))
    with pytest.raises(ValueError, match="tile_p"):
        small = rc.build_fused_plan(sh._syn, 8, *_shard_op(sh, 1), kv=p.kv)
        rc.fused_call(t.fused, x, wv=rc.vertical_tables(
            dataclasses.replace(small, win_v=p.win_v), prec, "cpu"))
    with pytest.raises(ValueError, match="bf16"):
        rc.fused_call(t.fused, x, wv=rc.vertical_tables(p, lanczos_torch.Precision.BF16, "cpu"))
    with pytest.raises(ValueError, match="lack the central-tap"):
        rc.fused_call(t.fused, x, wv=rc.vertical_tables(
            dataclasses.replace(p, center_v=None), prec, "cpu"))


def _shard_op(sh, r):
    """``build_fused_plan``'s operator arguments for shard ``r`` of ``sh``."""
    import types

    op_v, op_h, n, d, off = rc._operators(sh.cfg)
    ol, il, halo = sh.out_h_local, sh.in_h_local, sh.halo
    op = types.SimpleNamespace(idx=op_v.idx[r * ol : (r + 1) * ol] - (r * il - halo),
                               weights=op_v.weights[r * ol : (r + 1) * ol], a=int(op_v.a))
    return op, op_h, n, d, off + 2 * n * halo
