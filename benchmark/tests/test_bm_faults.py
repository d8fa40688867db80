"""The comparison that decides ``correct`` fails what it must, on the CPU at
the configurations' scales but a tiny size: the control (the program's own
path one precision below the configuration's), and the timed path broken
underneath the harness in each way that a cell can break — a call that
hands back the result of the call before, half of a batch left out, the
exchange between cards left out, an output byte altered where it is made.
The run is driven as on the card, with the look for a card skipped."""

from __future__ import annotations

import functools

import pytest
import torch

import lanczos_torch
from benchmark import harness
from lanczos_torch.models.upscaler import Upscaler
from lanczos_torch.parallel import sharded

from .test_bm_harness import CELLS, tiny

# where each cell's window enters the program: (owner, attribute)
ENTRY = {
    "perf8k-batch4-oncard": (Upscaler, "planar"),
    "quality4k-batch4-upscale": (lanczos_torch, "upscale"),
    "perf8k-video-host": (Upscaler, "__call__"),
    "perf8k-video-host-4card": (sharded.ShardedUpscaler, "__call__"),
}


def stale(fn):
    """Each call returns what the call before returned."""
    last = []

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        y = fn(*args, **kw)
        out = last[0] if last else y
        last[:] = [y]
        return out

    return wrapped


def half_batch(fn):
    """The second half of a batch is never computed."""

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        y = fn(*args, **kw).clone()
        y[y.shape[0] // 2:] = 0
        return y

    return wrapped


def altered(fn):
    """One byte of each output is changed where it is made."""

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        y = fn(*args, **kw).clone()
        y[tuple(s // 2 for s in y.shape)] += 64
        return y

    return wrapped


FAULTS = {"stale": stale, "half_batch": half_batch, "altered": altered}
# half of a batch can be left out only where a call carries several frames
CASES = [(name, fault) for name in CELLS for fault in FAULTS
         if fault != "half_batch" or harness.find_cell(name).traffic["batch"] > 1]


def run(name: str, seed: int = 2**31 + 17, control: bool = False) -> dict:
    cell = harness.find_cell(name)
    return harness.execute(cell, seed, 0.15, False, device="cpu", shape=tiny(cell),
                           control=control)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    r = run(name, control=True)
    limit = r["check"]["gap_lsb"]["limit"]
    assert not r["correct"] and r["check"]["gap_lsb"]["value"] > 10 * limit, r


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    owner, attr = ENTRY[name]
    monkeypatch.setattr(owner, attr, FAULTS[fault](getattr(owner, attr)))
    r = run(name)
    assert not r["correct"] and r["failed"] > 0, r


def test_the_exchange_left_out_is_not_correct(monkeypatch):
    """The gather to the first card keeps its own frames and never brings
    the other cards' results."""
    real = sharded.gather

    def no_exchange(mesh, blocks, device=None):
        first = mesh.local_positions()[0]
        every = real(mesh, blocks, device)
        return {p: b if p == first else torch.zeros_like(b) for p, b in every.items()}

    monkeypatch.setattr(sharded, "gather", no_exchange)
    r = run("perf8k-video-host-4card")
    assert not r["correct"] and r["failed"] > 0, r
