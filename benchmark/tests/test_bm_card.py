"""The comparison on the card, at each cell's own size: the program as its
configuration states passes, and the control (the program's own path one
precision below) fails, on three seeds each.  Skips without enough cards.

    python -m pytest benchmark/tests/test_bm_card.py -q
"""

from __future__ import annotations

import pytest

from benchmark import harness

from .test_bm_harness import CELLS

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture
def cards():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(name, cards):
    cell = harness.find_cell(name)
    if cards < cell.chips:
        pytest.skip(f"needs {cell.chips} cards, {cards} found")
    for seed in SEEDS:
        good = harness.execute(cell, seed, 1.0, False)
        bad = harness.execute(cell, seed, 1.0, False, control=True)
        assert good["correct"], good["check"]
        assert not bad["correct"], bad["check"]
