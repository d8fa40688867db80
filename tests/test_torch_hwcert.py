"""The port's certification harness (``lanczos_torch.tools.hwcert``) against
the JAX package's ``hwcert.py`` on the CPU: the same draws (every config
row of ``HWCERT.jsonl`` reproduced), the same limits, the JAX script's
four smoke cases as ``--cpu-smoke`` runs of the port, the port's output
against the JAX MXU kernel in interpret mode on the drawn images, and the
exit codes (1 on a row past its limit, 2 with no card)."""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.tools import hwcert as port  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import hwcert as ref  # noqa: E402

SMOKE = ["--cpu-smoke", "--workers", "2"]


def _fields(cfg, batch) -> dict:
    return {
        "in": tuple(cfg.in_shape), "out": tuple(cfg.out_shape),
        "scale": (tuple(cfg.scale_h), tuple(cfg.scale_w)), "a": cfg.a,
        "edge": cfg.edge_mode.value, "align": cfg.align.value, "order": cfg.order.value,
        "dering": cfg.dering, "quantize": cfg.intermediate_quantize,
        "normalize": cfg.normalize, "precision": cfg.precision.value, "batch": batch,
    }


@pytest.mark.parametrize("cpu_smoke", [False, True])
def test_draw_config_equals_hwcert_s(cpu_smoke):
    for seed in range(300):
        want_cfg, want_b = ref.draw_config(np.random.default_rng(seed), cpu_smoke)
        got_cfg, got_b = port.draw_config(np.random.default_rng(seed), cpu_smoke)
        assert _fields(got_cfg, got_b) == _fields(want_cfg, want_b), seed
        assert port.tolerance(got_cfg) == ref.tolerance(want_cfg), seed
        assert port.frac_limit(got_cfg) == (0.50 if want_cfg.precision.value == "bf16"
                                            else 0.01)


def _report_rows():
    rows = [json.loads(line) for line in (REPO / "HWCERT.jsonl").read_text().splitlines()]
    assert rows[-1]["summary"] and not any(r.get("summary") for r in rows[:-1])
    return rows[:-1]


def _row_class(r) -> str:
    return r.get("kind", "exact" if "exact" in r else "fuzz")


def test_port_draws_reproduce_hwcert_jsonl_fuzz_rows():
    rows = [r for r in _report_rows() if _row_class(r) == "fuzz"]
    assert len(rows) == 220
    assert [r["seed"] for r in rows] == list(range(48)) + list(range(100, 272))
    for r in rows:
        cfg, batch = port.draw_config(np.random.default_rng(r["seed"]), False)
        got = {
            "scale": f"{cfg.scale_h[0]}/{cfg.scale_h[1]}", "in": list(cfg.in_shape),
            "out": list(cfg.out_shape), "a": cfg.a, "edge": cfg.edge_mode.value,
            "align": cfg.align.value, "order": cfg.order.value, "dering": cfg.dering,
            "quantize": cfg.intermediate_quantize, "normalize": cfg.normalize,
            "precision": cfg.precision.value, "batch": batch, "tol": port.tolerance(cfg),
        }
        assert got == {k: r[k] for k in got}, r["seed"]


def test_port_draws_reproduce_hwcert_jsonl_aniso_rows():
    rows = [r for r in _report_rows() if _row_class(r) == "aniso"]
    assert [r["seed"] for r in rows] == [20_000 + k for k in range(6)]
    for r in rows:
        cfg = port.draw_aniso(r["seed"] - port.ANISO_SEED0, False)
        (n1, d1), (n2, d2) = cfg.scale_h, cfg.scale_w
        got = {"scale": f"{n1}/{d1}x{n2}/{d2}", "in": list(cfg.in_shape),
               "out": list(cfg.out_shape), "a": cfg.a, "edge": cfg.edge_mode.value,
               "align": cfg.align.value, "dering": cfg.dering, "batch": 1}
        assert got == {k: r[k] for k in got}, r["seed"]


def test_port_draws_reproduce_hwcert_jsonl_uint16_and_exact_rows():
    rows = _report_rows()
    u16 = [r for r in rows if _row_class(r) == "uint16"]
    assert [r["seed"] for r in u16] == [30_000 + k for k in range(12)]
    for r in u16:
        cfg, img = port.draw_u16(r["seed"] - port.U16_SEED0, False)
        got = {"scale": f"{cfg.scale_h[0]}/{cfg.scale_h[1]}", "in": list(cfg.in_shape),
               "a": cfg.a}
        assert got == {k: r[k] for k in got} and img.dtype == np.uint16, r["seed"]
    exact = [r for r in rows if _row_class(r) == "exact"]
    assert [r["seed"] for r in exact] == list(range(14))
    for r in exact:
        profile, cfg, img = port.draw_exact(r["seed"])
        got = {"profile": profile.value, "scale": f"{cfg.scale_h[0]}/{cfg.scale_h[1]}",
               "in": list(cfg.in_shape), "a": cfg.a}
        assert got == {k: r[k] for k in got} and img.shape == (*cfg.in_shape, 3)
    kinds = {_row_class(r) for r in rows}
    assert kinds == {"fuzz", "aniso", "uint16", "exact", "y4m_420p10", "y4m_422p12",
                     "y4m_mono"}


def _run(capsys, argv):
    rc = port.main(argv)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    return rc, lines[:-1], lines[-1]


def test_hwcert_cpu_smoke(capsys):
    rc, rows, summary = _run(capsys, SMOKE + [
        "--seeds", "4", "--exact-seeds", "2", "--aniso-seeds", "0", "--u16-seeds", "0",
        "--y4m", "0"])
    assert rc == 0
    assert summary["summary"] and summary["mode"] == "cpu-smoke"
    assert summary["device"] == "cpu" and summary["power_limit"] is None
    assert summary["passed"] + summary["failed"] == 6
    assert summary["failed"] == 0
    assert summary["exact_profiles"] == 2
    for row in rows:
        assert row["ok"]
        if "exact" in row:
            assert row["exact"]
            continue
        assert row["max_diff"] <= row["tol"] and row["frac_diff"] <= row["frac_lim"]
        assert row["kernels"] == {}  # the plain versions launch nothing
        assert row["mxu"] == (row["route"] == "fused")


def test_hwcert_draws_cover_dimensions():
    seen_edges, seen_orders, seen_scales = set(), set(), set()
    dering = quantize = batches = 0
    for seed in range(60):
        cfg, batch = port.draw_config(np.random.default_rng(seed), True)
        seen_edges.add(cfg.edge_mode.value)
        seen_orders.add(cfg.order.value)
        seen_scales.add(cfg.scale_h)
        dering += cfg.dering
        quantize += cfg.intermediate_quantize
        batches += batch > 1
        n, d = cfg.scale_h
        assert cfg.in_shape[0] * n % d == 0
    assert seen_edges == {"clamp", "reflect", "drop"}
    assert seen_orders == {"height_first", "width_first"}
    assert len(seen_scales) >= 5
    assert dering > 10 and quantize > 10 and batches > 5


def test_hwcert_report_file(tmp_path, capsys):
    out = tmp_path / "report.jsonl"
    rc = port.main(SMOKE + ["--seeds", "2", "--exact-seeds", "1", "--aniso-seeds", "0",
                            "--u16-seeds", "0", "--y4m", "0", "--out", str(out)])
    capsys.readouterr()
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows[-1]["summary"] and len(rows) == 4


def test_hwcert_extended_classes(capsys):
    rc, rows, summary = _run(capsys, SMOKE + [
        "--seeds", "0", "--exact-seeds", "0", "--aniso-seeds", "2", "--u16-seeds", "2",
        "--y4m", "1"])
    assert rc == 0
    assert summary["failed"] == 0
    assert summary["aniso"] == 2
    assert summary["uint16"] == 2
    assert summary["y4m"] == 3  # the full colorspace x depth matrix
    kinds = {r.get("kind") for r in rows}
    assert kinds == {"aniso", "uint16", "y4m_420p10", "y4m_422p12", "y4m_mono"}
    y4m_row = next(r for r in rows if r.get("kind") == "y4m_420p10")
    assert y4m_row["sha256_16"]  # artifact trail of the output bytes


def test_append_writes_one_summary(tmp_path, capsys):
    out = str(tmp_path / "r.jsonl")
    base = SMOKE + ["--exact-seeds", "0", "--aniso-seeds", "0", "--u16-seeds", "0",
                    "--y4m", "0", "--out", out]
    assert port.main(base + ["--seeds", "2", "--seed0", "0"]) == 0
    assert port.main(base + ["--seeds", "2", "--seed0", "100", "--append"]) == 0
    capsys.readouterr()
    rows = [json.loads(line) for line in Path(out).read_text().splitlines()]
    assert [r.get("seed") for r in rows[:-1]] == [0, 1, 100, 101]
    assert rows[-1]["summary"] and rows[-1]["seeds"] == 4 and rows[-1]["failed"] == 0
    assert sum(1 for r in rows if r.get("summary")) == 1


def test_no_fused_plan_runs_kernel_2_and_v1(capsys):
    """Every drawn config has a fused plan; the configs kernel 2 or v1 also
    take run through them too, under the same limits."""
    rc, rows, summary = _run(capsys, SMOKE + [
        "--seeds", "12", "--exact-seeds", "0", "--aniso-seeds", "0", "--u16-seeds", "0",
        "--y4m", "0"])
    assert rc == 0
    alts = [r["no_fused_plan"] for r in rows if r["no_fused_plan"]]
    assert {a["route"] for a in alts} == {"v1", "v2"}
    assert summary["no_fused_plan"] == {
        k: sum(1 for a in alts if a["route"] == k) for k in ("v2", "v1")}
    for r in rows:
        a = r["no_fused_plan"]
        if a:
            assert a["ok"] and a["max_diff"] <= r["tol"] and a["frac_diff"] <= r["frac_lim"]


@pytest.mark.parametrize("seed", range(4))
def test_port_within_the_jax_mxu_kernel_in_interpret_mode(seed):
    """As ``hwcert.py``'s smoke mode runs the reference: its MXU kernel in
    the Pallas interpreter on the drawn image, against the port's
    ``backend="pallas"`` on the CPU (the fused kernel's plain version)."""
    from lanczos_tpu.ops.resample_pallas import PallasOps, resample_2d_pallas

    rng = np.random.default_rng(seed)
    jcfg, batch = ref.draw_config(rng, True)
    h, w = jcfg.in_shape
    img = rng.integers(0, 256, size=(batch, h, w, 3), dtype=np.uint8)
    if batch == 1:
        img = img[0]
    ops = PallasOps(jcfg, interpret=True, variant="mxu")
    want = np.asarray(jax.jit(functools.partial(resample_2d_pallas, ops=ops))(jnp.asarray(img)))

    cfg, _ = port.draw_config(np.random.default_rng(seed), True)
    got = lanczos_torch.Upscaler(cfg, backend="pallas", device="cpu")(
        torch.from_numpy(img)).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= port.tolerance(cfg) and (d > 0).mean() <= port.frac_limit(cfg)


def test_a_row_past_its_limit_fails_the_run(monkeypatch, capsys):
    """+2 on one pixel of the device's output (seed 0: fp32, linear, tol 1)
    fails that row, and ``main`` returns 1."""
    from lanczos_torch.models.upscaler import Upscaler

    call = Upscaler.__call__

    def off_by_two(self, img):
        y = call(self, img)
        if self.backend == "pallas":
            y = y.clone()
            v = int(y[0, 0, 0])
            y[0, 0, 0] = v + 2 if v <= 253 else v - 2
        return y

    monkeypatch.setattr(Upscaler, "__call__", off_by_two)
    rc, rows, summary = _run(capsys, SMOKE + [
        "--seeds", "1", "--exact-seeds", "0", "--aniso-seeds", "0", "--u16-seeds", "0",
        "--y4m", "0"])
    assert rc == 1
    assert summary["failed"] == 1 and not rows[0]["ok"] and rows[0]["max_diff"] == 2
    assert rows[0]["tol"] == 1


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port.main(["--seeds", "1", "--exact-seeds", "0"]) == 2
    assert port.main(["--seeds", "1", "--device", "cuda:0"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "needs a CUDA device" in captured.err


def test_the_committed_report_covers_hwcert_jsonl_s_seeds():
    """``HWCERT_TORCH.jsonl``, the harness's run on the card: the seeds of
    ``HWCERT.jsonl`` class by class, the same configs, every row within
    its limits against the float64 gather, one summary naming the card."""
    lines = [json.loads(line) for line in
             (REPO / "HWCERT_TORCH.jsonl").read_text().splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert summary["summary"] and not any(r.get("summary") for r in rows)
    assert summary["mode"] == "hardware" and summary["device"] == "NVIDIA H100 80GB HBM3"
    assert summary["power_limit"].startswith("NVIDIA H100 80GB HBM3, ")
    assert summary["power_limit"].endswith(" W")
    assert (summary["seeds"], summary["passed"], summary["failed"]) == (255, 255, 0)
    assert summary["mxu_configs"] == 226 and summary["exact_profiles"] == 14
    want = {}
    for r in _report_rows():
        want.setdefault(_row_class(r), []).append(r)
    got = {}
    for r in rows:
        got.setdefault(_row_class(r), []).append(r)
    assert {k: sorted(r["seed"] for r in v) for k, v in got.items()} == {
        k: sorted(r["seed"] for r in v) for k, v in want.items()}
    config_keys = {
        "fuzz": ("scale", "in", "out", "a", "edge", "align", "order", "dering", "quantize",
                 "normalize", "precision", "batch", "tol"),
        "aniso": ("scale", "in", "out", "a", "edge", "align", "dering", "batch"),
        "uint16": ("scale", "in", "a", "tol"),
        "exact": ("profile", "scale", "in", "a"),
    }
    for cls, keys in config_keys.items():
        by_seed = {r["seed"]: r for r in want[cls]}
        for r in got[cls]:
            assert {k: r[k] for k in keys} == {k: by_seed[r["seed"]][k] for k in keys}
    for r in rows:
        assert r["ok"], r["seed"]
        if "exact" in r:
            assert r["exact"]
        elif "frac_lim" in r:  # fuzz and aniso: a kernel ran, within the limits
            assert r["kernels"] and r["max_diff"] <= r["tol"]
            assert r["frac_diff"] <= r["frac_lim"] == (0.5 if r["precision"] == "bf16" else 0.01)
        else:  # uint16 and .y4m
            assert r["max_diff"] <= r["tol"] == 1 and r["frac_diff"] <= 0.01
