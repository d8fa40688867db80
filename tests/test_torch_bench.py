"""The port's benchmark scripts (``lanczos_torch.tools.bench`` and
``bench_suite``) on the CPU: every row of the JAX suite under its JAX name,
in order, with null values off the card; the headline's line with the JAX
keys; exit 2 with no card and 1 on a row outside its contract; each row's
config at its CPU shape against ``lanczos_tpu``'s ``Upscaler(cfg,
backend="xla")`` within the reference's contract (fp32 ≤ 1 LSB on ≤ 1% of
pixels, the quantized intermediate ≤ 2, bf16 ≤ 3 LSB on ≤ 50%); and each
row's roofline equal to ``utils/profiling.Roofline.for_config``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lanczos_tpu  # noqa: E402

from lanczos_torch.models.upscaler import Upscaler  # noqa: E402
from lanczos_torch.tools import bench, bench_suite  # noqa: E402
from lanczos_torch.utils.profiling import Roofline  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
ROWS = [
    "256x256->512x512_a2", "1080p->4K_a3", "batch32_1080p->4K_a3",
    "batch32_1080p->4K_a3_planar", "4K->8K_a3", "4K->8K+1px_a3_largeN",
    "4K->8K_a3_dropnorm", "4K->8K_a3_dropdering", "4K->8K_a3_wf_quant",
    "7680x4320_a3_bf16", "stream7680x4320_a3_chunk1024",
]
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_nominal_roofline", "band_ms",
                 "bf16_mpix_s", "bf16_vs_baseline", "bf16_band_ms"}


@pytest.fixture
def one_thread():
    """The plain versions' many small ops in one thread: the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_suite_prints_every_jax_row_on_the_cpu(one_thread, capsys):
    rc = bench_suite.main(["--device", "cpu", "--bf16", "--mesh", "2", "--devices", "4",
                           "--frames", "4"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    rows = _lines(captured.out)
    assert [r["metric"] for r in rows] == ROWS + [
        "7680x4320_a3_mesh2x2", "video4f_7680x4320_mesh2x2"]
    for r in rows:
        assert r["value"] is None and r["vs_baseline"] is None and r["band_ms"] is None
        assert r["device"] == "cpu"
        assert r["kernels"] and all(k.startswith("fused_resample_") for k in r["kernels"])
        assert r["launches"] == {}  # the CPU runs the plain versions: no kernel launches
    assert rows[-1]["unit"] == "frames/s" and rows[-1]["frames"] == 4
    for r in rows[-2:]:
        assert r["virtual_mesh"] is True
    assert rows[-2]["measured_eff"] is None and rows[-2]["model_eff"] is None
    assert rows[ROWS.index("4K->8K_a3_dropdering")]["kernels"] == ["fused_resample_fp32_dering"]
    assert rows[ROWS.index("7680x4320_a3_bf16")]["kernels"] == ["fused_resample_bf16"]
    # the roofline each row reports is Roofline.for_config's, at the shape it ran
    by_name = {c.name: c for c in bench_suite.CASES + [bench_suite.BF16]}
    for r in rows[:-3]:
        case = by_name[r["metric"].removesuffix("_planar")]
        cfg = case.config(False)
        assert r["shape"] == [list(cfg.in_shape), list(cfg.out_shape)]
        want = Roofline.for_config(cfg, "cpu", max(case.batch, 1)).hbm_bytes
        assert r["hbm_bytes"] == want and r["roofline_ms"] is None
    assert "# FAIL" not in captured.err


def test_bench_prints_the_jax_keys_on_the_cpu(one_thread, capsys):
    assert bench.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    (line,) = _lines(captured.out)
    assert HEADLINE_KEYS <= set(line)
    assert line["metric"] == "3840x2160->7680x4320_lanczos3_upscale"
    assert all(line[k] is None for k in HEADLINE_KEYS - {"metric", "unit"})
    assert line["device"] == "cpu" and line["unit"] == "Mpix/s" and line["launches"] == {}
    assert "fused_resample_fp32" in captured.err and "fused_resample_bf16" in captured.err


def test_no_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    assert bench_suite.main(["--bf16"]) == 2
    assert bench_suite.main(["--device", "cuda:0"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "needs a CUDA device" in captured.err
    with pytest.raises(SystemExit):  # the mesh must divide the positions
        bench_suite.main(["--device", "cpu", "--mesh", "2", "--devices", "3"])


def _off_by_two(call):
    def patched(self, img):
        y = call(self, img)
        if self.backend != "xla":
            y = y.clone(memory_format=torch.contiguous_format)
            flat = y.view(-1)
            flat[0] = flat[0] + 2 if flat[0] <= 253 else flat[0] - 2
        return y
    return patched


def test_a_row_outside_its_contract_fails_the_run(monkeypatch, capsys, one_thread):
    """+2 on one pixel of the measured route's output: the first row (and
    the headline's fp32 tier) is outside the fp32 contract, and each script
    exits 1 before it prints a row."""
    monkeypatch.setattr(Upscaler, "__call__", _off_by_two(Upscaler.__call__))
    monkeypatch.setattr(Upscaler, "planar", _off_by_two(Upscaler.planar))
    assert bench_suite.main(["--device", "cpu"]) == 1
    assert bench.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert _lines(captured.out) == []
    assert captured.err.count("# FAIL") == 2 and "max|d|=2" in captured.err


def test_a_streamed_frame_one_level_off_fails_the_row(monkeypatch, capsys, one_thread):
    """Every pixel of the streamed frame one level up: within 1 LSB of the
    whole-frame call, but past the fp32 contract against ``backend="xla"``
    (≤ 1 LSB on ≤ 1%), so the row fails before it prints."""
    import argparse

    from lanczos_torch.models.streaming import StreamingUpscaler

    call = StreamingUpscaler.__call__

    def one_up(self, img):
        y = torch.as_tensor(call(self, img))
        return torch.where(y < 255, y + 1, y - 1).to(torch.uint8)

    suite = bench_suite.Suite(argparse.Namespace(backend="auto", iters=1), torch.device("cpu"))
    suite.stream_row()  # unpatched, the row passes
    monkeypatch.setattr(StreamingUpscaler, "__call__", one_up)
    with pytest.raises(bench.OutsideContract, match="max.d.=1 on 1.0"):
        suite.stream_row()
    assert _lines(capsys.readouterr().out)[0]["metric"] == bench_suite.STREAM.name


@pytest.mark.parametrize("case", bench_suite.CASES + [bench_suite.BF16],
                         ids=lambda c: c.name)
def test_row_configs_match_jax_xla(case, one_thread):
    """The port's route for each row's config at its CPU shape against the
    JAX package's ``xla`` backend, inputs from one numpy seed."""
    from lanczos_tpu.core.config import ResampleConfig as JCfg
    from lanczos_tpu.models.upscaler import Upscaler as JUpscaler

    cfg = case.config(False)
    lead = (min(case.batch, 4),) if case.batch else ()
    img = np.random.default_rng(7).integers(0, 256, lead + tuple(cfg.in_shape) + (3,),
                                            dtype=np.uint8)
    got = Upscaler(cfg, device="cpu")(torch.from_numpy(img)).numpy()
    # bf16 is held to the reference's fp32 result, as the other port tests hold it
    kw = dict(case.kw, precision="fp32")
    jcfg = JCfg.from_profile("precise", cfg.in_shape, out_shape=cfg.out_shape, a=case.a, **kw)
    want = np.asarray(JUpscaler(jcfg, backend="xla")(img))
    lim, frac = bench.contract(cfg)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and d.max() <= lim and (d > 0).mean() <= frac, (
        d.max(), (d > 0).mean())


def test_rooflines_are_profilings_and_rotation_exceeds_the_l2():
    """The 4K->8K roofline on the H100 (124.4 MB in and out, 0.0371 ms at
    3.35 TB/s) as each card row computes it, and each card row's rotation
    of inputs over the 50 MB L2."""
    cfg = bench_suite.CASES[3].config(True)
    roof = Roofline.for_config(cfg, H100)
    assert roof.hbm_bytes == 3 * (2160 * 3840 + 4320 * 7680)
    assert round(roof.hbm_bytes / 1e6, 1) == 124.4
    assert round(roof.min_seconds * 1e3, 4) == 0.0371
    assert round(roof.fraction(0.1398e-3), 2) == 0.27
    for case in bench_suite.CASES:
        c = case.config(True)
        nbytes = max(case.batch, 1) * 3 * c.in_shape[0] * c.in_shape[1]
        k = bench.rotation(nbytes)
        assert k * nbytes > bench.L2_BYTES >= (k - 1) * nbytes
    assert bench.rotation(4 * 3 * 2160 * 3840) == 1  # the headline's batch of 4
    assert bench.rotation(3 * 2160 * 3840) == 3


def test_check_limits():
    a = torch.zeros((10, 10), dtype=torch.uint8)
    b = a.clone()
    b[0, 0] = 1
    assert bench.diff("one", b, a) == (1, 0.01)
    assert bench.check("one", b, a, (1, 0.01)) == (1, 0.01)
    b[0, 1] = 1
    with pytest.raises(bench.OutsideContract):
        bench.check("two", b, a, (1, 0.01))
    assert bench.check("two", b, a.numpy(), bench.ONE_LSB)[0] == 1
    with pytest.raises(bench.OutsideContract):
        bench.check("shape", b[:5], a, (3, 0.5))
    with pytest.raises(bench.OutsideContract):
        bench.check("exact", b, a, bench.EXACT)
