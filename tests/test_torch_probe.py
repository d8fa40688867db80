"""The kernel probes (``lanczos_torch.tools.probe_kernels``) on the CPU: every
probe's substitution still finds its text, exactly once, in the production
source it cuts, so the tool cannot rot silently as the kernels change; the
probes themselves build and run only on the card."""

import pytest

torch = pytest.importorskip("torch")

from lanczos_torch.tools import probe_kernels as pk  # noqa: E402

TABLES = {"lanczos_fused_resample": pk.FUSED_PROBES, "lanczos_shift_resample": pk.SHIFT_PROBES,
          **pk.PHASE_PROBES}
PROBES = [(fn, n) for fn, table in TABLES.items() for n in table]


@pytest.mark.parametrize("function,name", PROBES)
def test_probe_substitution_applies(function, name):
    table = TABLES[function]
    src = pk.probe_source(function, table[name])
    original = (pk._build.CSRC / pk.SOURCES[function]).read_text()
    assert src != original and function in src
    for old, new in table[name]:
        assert new in src


def test_probe_refuses_a_changed_source():
    with pytest.raises(ValueError, match="expected once"):
        pk.probe_source("lanczos_fused_resample", [("no such text in the kernel", "x")])


def test_phase_probes_cover_every_v1_kernel_and_index_their_arguments():
    """Each v1 design's library function has probes, and the two arguments
    the tool overrides at run time sit where it indexes them."""
    from lanczos_torch.core.config import ResampleConfig
    from lanczos_torch.ops import resample_phase_cuda as rp

    assert set(pk.PHASE_PROBES) == {"lanczos_phase_window", "lanczos_phase_stream_v",
                                    "lanczos_phase_stream_h"}
    for fn, table in pk.PHASE_PROBES.items():
        assert {"empty", "loads"} <= set(table) and pk.SOURCES[fn] == "phase_resample.cu"
    src = (pk._build.CSRC / "phase_resample.cu").read_text()
    sig_v = src[src.index('extern "C" int lanczos_phase_stream_v('):].split(")")[0]
    assert [a.split()[-1] for a in sig_v.split("(")[1].split(",")][11] == "rpc"
    sig_h = src[src.index('extern "C" int lanczos_phase_stream_h('):].split(")")[0]
    assert [a.split()[-1] for a in sig_h.split("(")[1].split(",")][11:13] == ["tc", "eh"]
    sig_w = src[src.index('extern "C" int lanczos_phase_window('):].split(")")[0]
    assert [a.split()[-1] for a in sig_w.split("(")[1].split(",")][25] == "templ"
    # phase_call passes 8 pointers, the planes and 4 sizes, then the plan's scalars
    ops = rp.PhaseOps(ResampleConfig.from_profile("precise", (24, 40), out_shape=(36, 60)), "cpu")
    assert ops.design == "window" and 8 + 5 + len(ops.scalars) - 1 == 25
    assert ops.scalars[-1] == int(ops.layout["templ"]) == 1


def test_probe_cli_refuses_unknown_and_needs_a_card(capsys):
    assert pk.main(["wgmma"]) == 2
    assert "choose from" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert pk.main(["fused"]) == 2
        assert "CUDA device" in capsys.readouterr().err
