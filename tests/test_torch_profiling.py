"""The port's ``utils/profiling.py`` against ``lanczos_tpu.utils.profiling``
on the CPU: ``Roofline`` field for field, ``chip_spec`` (the H100 entry, no
fallback for a card it does not know), ``kernel_bound`` at the shapes
``PERF.md`` quotes, ``time_fn`` and ``trace``; and the package names the
port exports as the JAX package does."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_tpu.core.config import ResampleConfig as JaxConfig  # noqa: E402
from lanczos_tpu.utils import profiling as jprof  # noqa: E402

import lanczos_torch  # noqa: E402
from lanczos_torch.utils import profiling as prof  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

ROOFLINE_CASES = [  # (in, out, batch)
    ((2160, 3840), (4320, 7680), 1),  # 4K -> 8K
    ((2160, 3840), (1080, 1920), 1),  # 1/2
    ((1440, 2560), (2160, 3840), 1),  # 3/2
    ((1080, 1920), (2160, 3840), 4),  # batch 4
]


@pytest.mark.parametrize("in_shape,out_shape,batch", ROOFLINE_CASES)
def test_roofline_equals_the_jax_formula(in_shape, out_shape, batch):
    kw = dict(out_shape=out_shape, a=3)
    want = jprof.Roofline.for_config(JaxConfig.from_profile("precise", in_shape, **kw),
                                     batch=batch)
    got = prof.Roofline.for_config(
        lanczos_torch.ResampleConfig.from_profile("precise", in_shape, **kw),
        device="cpu", batch=batch)
    assert (got.hbm_bytes, got.flops) == (want.hbm_bytes, want.flops)
    assert (got.bw, got.peak_flops) == prof.CHIP_SPECS["cpu"] == jprof.CHIP_SPECS["cpu"]
    assert got.min_seconds == pytest.approx(want.min_seconds)
    assert got.fraction(got.min_seconds * 4) == pytest.approx(0.25)
    assert got.mpix_per_s() == pytest.approx(out_shape[0] * out_shape[1] / 1e6 / got.min_seconds)


def test_roofline_on_the_h100_is_bytes_bound():
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (2160, 3840), scale=(2, 1))
    r = prof.Roofline.for_config(cfg, device="NVIDIA H100 80GB HBM3")
    assert r.hbm_bytes == 3 * (2160 * 3840 + 4320 * 7680)
    assert r.min_seconds == pytest.approx(r.hbm_bytes / 3.35e12)


def test_chip_spec_h100_and_no_fallback(monkeypatch):
    assert prof.chip_spec("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert prof.chip_spec("cpu") == prof.chip_spec(torch.device("cpu")) == (50e9, 1e12)
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        prof.chip_spec("NVIDIA A100-SXM4-80GB")
    # an unknown CUDA card raises naming torch.cuda.get_device_name()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA L4")
    with pytest.raises(ValueError, match="NVIDIA L4"):
        prof.chip_spec(torch.device("cuda", 0))
    # with no device named and no card there is no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prof.chip_spec()


@pytest.mark.parametrize("in_shape,out_shape,want", [
    ((2160, 3840), (4320, 7680), 0.0371),  # 4K -> 8K
    ((4320, 7680), (270, 480), 0.0298),  # 8K thumbnail (v1 stream)
    ((1440, 2560), (2160, 3840), 0.0107),  # 1440p -> 4K, 3/2 (v1 window)
    ((2160, 2880), (2160, 3840), 0.0130),  # desqueeze, 1/1 by 4/3
])
def test_kernel_bound_is_perf_md_s_bound(in_shape, out_shape, want):
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", in_shape, out_shape=out_shape,
                                                    a=3)
    b = prof.kernel_bound(cfg, 3)
    assert round(b["bound_ms"], 4) == want and b["bound_by"] == "bytes"
    assert b["bytes"] == 3 * (in_shape[0] * in_shape[1] + out_shape[0] * out_shape[1])
    assert prof.bound_of(b["bytes"], b["flops"]) == {k: b[k] for k in ("bound_ms", "bound_by")}


def test_kernel_bound_counts_a_downscale_s_footprint():
    """``kernel_bound`` counts 2a·D/N taps a value on a 1/D axis, where the
    JAX ``Roofline`` counts 2a: at 1/16 the taps, not the bytes, bound."""
    cfg = lanczos_torch.ResampleConfig.from_profile("precise", (4320, 7680),
                                                    out_shape=(270, 480), a=3)
    b = prof.kernel_bound(cfg, 3)
    taps = 2 * 3 * 16
    assert b["flops"] == 2.0 * 3 * (270 * 7680 * taps + 270 * 480 * taps)
    assert prof.bound_of(1, 1e12)["bound_by"] == "operations"


def test_chip_smoke_keeps_no_copy_of_the_bound():
    text = (REPO / "chip_smoke.py").read_text()
    assert "from lanczos_torch.utils.profiling import" in text
    assert "def bound(" not in text and "def gather_f64(" not in text
    assert "HBM_TBPS = " not in text and "FP32_PEAK_TFLOPS = " not in text


def test_time_fn_on_the_cpu_is_host_time():
    x = torch.ones(64, 64)
    calls = []

    def fn(t):
        calls.append(1)
        return t @ t

    dt = prof.time_fn(fn, x, iters=3, warmup=2)
    assert dt > 0 and len(calls) == 5


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(32, 32)
    with prof.trace(str(tmp_path / "t")) as logdir:
        (x @ x).sum()
    path = Path(logdir) / "trace.json"
    assert path.is_file()
    assert "traceEvents" in json.loads(path.read_text())


# every name ``lanczos_tpu.ops`` / ``lanczos_tpu.utils`` export, and its
# counterpart in the port
NAMES = {
    ("lanczos_tpu.ops", "apply_banded"): ("lanczos_torch.ops", "apply_banded"),
    ("lanczos_tpu.ops", "quantize_uint8"): ("lanczos_torch.ops", "quantize_uint8"),
    ("lanczos_tpu.ops", "resample_2d_xla"): ("lanczos_torch.ops", "resample_2d_gather"),
    ("lanczos_tpu.ops", "hls_upscale_xla"): ("lanczos_torch.ops", "hls_upscale"),
    ("lanczos_tpu.utils", "psnr"): ("lanczos_torch.utils", "psnr"),
    ("lanczos_tpu.utils", "rms_error"): ("lanczos_torch.utils", "rms_error"),
}


@pytest.mark.parametrize("package", ["ops", "utils"])
def test_every_jax_package_name_is_in_the_table(package):
    import importlib

    jax_mod = importlib.import_module(f"lanczos_tpu.{package}")
    public = {n for n in vars(jax_mod) if not n.startswith("_")
              and callable(getattr(jax_mod, n))}
    assert public == {n for m, n in NAMES if m == f"lanczos_tpu.{package}"}


@pytest.mark.parametrize("jax_name,port_name", sorted(NAMES.items()))
def test_port_exports_the_counterpart(jax_name, port_name):
    import importlib

    jax_obj = getattr(importlib.import_module(jax_name[0]), jax_name[1])
    port_mod = importlib.import_module(port_name[0])
    port_obj = getattr(port_mod, port_name[1])
    assert callable(jax_obj) and callable(port_obj)
    # the counterpart is the port's own function, defined in the port
    assert port_obj.__module__.startswith("lanczos_torch.")
    if jax_name[0] == "lanczos_tpu.utils":  # the metrics take arrays in both
        rng = np.random.default_rng(0)
        a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-3, 4, a.shape), 0, 255).astype(np.uint8)
        assert port_obj(a, b) == pytest.approx(jax_obj(a, b))


def test_the_ops_package_imports_no_kernel_wrapper():
    text = (REPO / "lanczos_torch" / "ops" / "__init__.py").read_text()
    assert "_cuda" not in text.split('"""')[-1]
