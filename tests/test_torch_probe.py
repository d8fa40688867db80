"""The kernel probes (``lanczos_torch.tools.probe_kernels``) on the CPU: every
probe's substitution still finds its text, exactly once, in the production
source it cuts, so the tool cannot rot silently as the kernels change; the
probes themselves build and run only on the card."""

import pytest

torch = pytest.importorskip("torch")

from lanczos_torch.tools import probe_kernels as pk  # noqa: E402

PROBES = [("lanczos_fused_resample", n) for n in pk.FUSED_PROBES] + [
    ("lanczos_shift_resample", n) for n in pk.SHIFT_PROBES]


@pytest.mark.parametrize("function,name", PROBES)
def test_probe_substitution_applies(function, name):
    table = pk.FUSED_PROBES if function == "lanczos_fused_resample" else pk.SHIFT_PROBES
    src = pk.probe_source(function, table[name])
    original = (pk._build.CSRC / pk.SOURCES[function]).read_text()
    assert src != original and function in src
    for old, new in table[name]:
        assert new in src


def test_probe_refuses_a_changed_source():
    with pytest.raises(ValueError, match="expected once"):
        pk.probe_source("lanczos_fused_resample", [("no such text in the kernel", "x")])


def test_probe_cli_refuses_unknown_and_needs_a_card(capsys):
    assert pk.main(["wgmma"]) == 2
    assert "choose from" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert pk.main(["fused"]) == 2
        assert "CUDA device" in capsys.readouterr().err
