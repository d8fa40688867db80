"""The port's 16-bit path (``precision="bf16"``) held to its own rounding
contract on the CPU: the contract's plain reference
(``benchmark/reference/lanczos_bf16.py``, written from the configuration
file ``benchmark/configs/fsr1-performance-8k-16bit.json``) against a direct
sum in exact rationals, the port's plain version and the port's rounded
weights against the reference, and the bf16 arithmetic broken each way
that a limit of 3 LSB on half the pixels would let through, each read
above the configuration's limit."""

from __future__ import annotations

import json
import math
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import lanczos_torch
from lanczos_torch.core.config import ResampleConfig
from lanczos_torch.ops import resample_cuda as rc

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import lanczos_bf16 as ref  # noqa: E402

CONF = json.loads((ROOT / "benchmark" / "configs" / "fsr1-performance-8k-16bit.json").read_text())
LIMIT = CONF["limits"]["gap_lsb"]
SOUND = CONF["cpu_test"]["gap_lsb"]  # what a sound run reads below


def frame(kind: str, shape, seed: int) -> torch.Tensor:
    """``(2, 3, H, W)`` uint8: seeded noise, a diagonal gradient, or noise
    with its border rows and columns at 0 and 255 (the clamped edges)."""
    h, w = shape
    x = torch.randint(0, 256, (2, 3, h, w), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(seed))
    if kind == "gradient":
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        g = (yy * 255 // max(h - 1, 1) + xx * 255 // max(w - 1, 1)) // 2
        x = torch.stack([g, 255 - g, (g * 7) % 256]).to(torch.uint8).expand(2, 3, h, w)
    elif kind == "edges":
        x = x.clone()
        x[..., 0, :], x[..., -1, :], x[..., :, 0], x[..., :, -1] = 255, 0, 0, 255
    return x.contiguous()


def cfg_of(in_shape, out_shape, precision="bf16") -> ResampleConfig:
    return ResampleConfig.from_profile(CONF["profile"], in_shape, out_shape=out_shape,
                                       a=CONF["a"], precision=precision)


def planar(x: torch.Tensor, out_shape, precision="bf16") -> torch.Tensor:
    """The port on ``(B, C, H, W)``, as the benchmark's cell calls it."""
    cfg = cfg_of(tuple(x.shape[-2:]), out_shape, precision)
    return lanczos_torch.Upscaler(cfg, backend="auto", device="cpu").planar(x)


def gap(y: torch.Tensor, x: torch.Tensor) -> float:
    """The widest gap of the outputs ``y`` from the reference of ``x``."""
    (h, w), (oh, ow) = x.shape[-2:], y.shape[-2:]
    r = ref.exact(x.reshape(-1, h, w), CONF, (oh, ow))
    y = y.reshape(-1, oh, ow)
    return max(ref.gap_lsb(y[p], r[p]) for p in range(y.shape[0]))


CASES = {
    "2/1-noise": ("noise", (24, 32), (48, 64)),
    "2/1-gradient": ("gradient", (24, 32), (48, 64)),
    "2/1-edges-odd": ("edges", (13, 17), (26, 34)),
    "3/2-noise": ("noise", (32, 48), (48, 72)),
    "3/2-gradient": ("gradient", (32, 48), (48, 72)),
    "3/2-edges-odd": ("edges", (20, 30), (30, 45)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_ports_bf16_planar_path_keeps_the_contract(case):
    kind, in_shape, out_shape = CASES[case]
    x = frame(kind, in_shape, seed=2**31 + len(case))
    assert gap(planar(x, out_shape), x) <= SOUND


def _dense(plan_w, starts, n_out, n_in, uniq=None) -> np.ndarray:
    """A plan's banded matrix (tiles of ``wv``, or blocks of ``wh``) as
    ``(n_out, n_in)``."""
    out = np.zeros((n_out, n_in))
    for i, s in enumerate(starts):
        m = plan_w[i] if uniq is None else plan_w[uniq[i]].T
        lo = i * m.shape[0]
        hi = min(lo + m.shape[0], n_out)
        out[lo:hi, s:s + m.shape[1]] = m[:hi - lo]
    return out


@pytest.mark.parametrize("shapes", [((2160, 3840), (4320, 7680)), ((1440, 2560), (2160, 3840))],
                         ids=["2/1", "3/2"])
def test_the_references_rounded_weights_are_the_ports(shapes):
    (h, w), (oh, ow) = shapes
    plan = rc.fused_plan(cfg_of((h, w), (oh, ow)))
    wv, wh = rc.plan_weights(plan, "bf16")
    got_v = _dense(wv, plan.starts_v, oh, h)
    got_h = _dense(wh, plan.starts_h, ow, w, plan.uniq_h)
    for got, (n_in, n_out) in ((got_v, (h, oh)), (got_h, (w, ow))):
        idx, r = ref.rounded_taps(n_in, n_out, CONF)
        want = np.zeros((n_out, n_in))
        np.add.at(want, (np.arange(n_out)[:, None].repeat(idx.shape[1], 1), idx), r)
        assert np.array_equal(got, want)


def _rne(q: Fraction, bits: int) -> Fraction:
    """``q`` rounded to ``bits`` significant bits, ties to even."""
    if q == 0:
        return q
    e = math.floor(math.log2(abs(q)))
    while abs(q) >= Fraction(2) ** (e + 1):
        e += 1
    while abs(q) < Fraction(2) ** e:
        e -= 1
    step = Fraction(2) ** (e - bits + 1)
    n = q / step
    k = math.floor(n)
    if n - k > Fraction(1, 2) or (n - k == Fraction(1, 2) and k % 2):
        k += 1
    return k * step


def _direct(img: np.ndarray, out_shape, a: int) -> np.ndarray:
    """Every output of the contract in exact rationals, each step written
    out: the kernel as ``a·sin(πt)·sin(πt/a)/(π²t²)`` inside ``|t| < a``,
    clamped taps summed, normalized; the weights through float32 to bf16, the residual onto the
    first of the largest; the intermediate rounded to bf16; the exact
    horizontal sum."""

    def kernel(t):
        if t == 0:
            return 1.0
        if abs(t) >= a:
            return 0.0
        return a * math.sin(math.pi * t) * math.sin(math.pi * t / a) / (math.pi ** 2 * t * t)

    def taps(y, n_in, n_out):
        x = y * n_in / n_out
        base = math.floor(x)
        w = {}
        raw = [(min(max(i, 0), n_in - 1), kernel(x - i)) for i in range(base - a + 1, base + a + 1)]
        s = sum(v for _, v in raw)
        for i, v in raw:
            w[i] = w.get(i, 0.0) + v / s
        exact = {i: Fraction(v) for i, v in w.items()}
        r = {i: _rne(_rne(v, 24), 8) for i, v in exact.items()}
        top = max(sorted(r), key=lambda i: abs(r[i]))  # max keeps the first of equals
        r[top] = _rne(_rne(r[top] + sum(exact.values()) - sum(r.values()), 24), 8)
        return r

    (h, w), (oh, ow) = img.shape, out_shape
    mid = [[_rne(sum(c * int(img[i, x]) for i, c in taps(y, h, oh).items()), 8)
            for x in range(w)] for y in range(oh)]
    out = np.zeros(out_shape)
    for x in range(ow):
        tx = taps(x, w, ow)
        for y in range(oh):
            out[y, x] = float(sum(c * mid[y][i] for i, c in tx.items()))
    return out


def test_the_reference_is_the_direct_sum_on_a_6x5_frame():
    img = np.stack([frame("noise", (6, 5), 3)[0, 0].numpy(),
                    frame("gradient", (6, 5), 3)[0, 0].numpy()])
    r = ref.exact(torch.from_numpy(img), CONF, (12, 10))
    for p in range(2):
        want = _direct(img[p], (12, 10), CONF["a"])
        lo, hi = r[p].real.numpy(), r[p].imag.numpy()
        assert np.all(lo - 1e-9 <= want) and np.all(want <= hi + 1e-9)
        point = lo == hi
        assert point.mean() > 0.9
        np.testing.assert_allclose(lo[point], want[point], rtol=0, atol=1e-9)


@pytest.mark.parametrize("shapes", [((270, 480), (540, 960)), ((240, 480), (360, 720))],
                         ids=["2/1", "3/2"])
def test_the_interval_is_a_point_almost_everywhere(shapes):
    (h, w), out_shape = shapes
    x = frame("noise", (h, w), 5)[0]
    r = ref.exact(x, CONF, out_shape)
    assert (r.real == r.imag).double().mean() >= 0.99
    assert bool((r.real <= r.imag).all())


# ---------------------------------------------------------------------------
# the bf16 arithmetic broken, each way read above the limit
# ---------------------------------------------------------------------------

FAULT_SHAPES = ((24, 32), (48, 64))


def _round_bits(t: torch.Tensor, bits: int) -> torch.Tensor:
    m, e = torch.frexp(t.double())
    return torch.ldexp(torch.round(torch.ldexp(m, torch.tensor(bits))), e - bits).float()


def _drop_outer(w: np.ndarray, axis: int) -> np.ndarray:
    """Each output's last tap of any size (past the taps of about 1e-17)
    set to 0, where it is an outer lobe's (under 0.1: not the central tap,
    nor the clamped taps folded onto an edge sample)."""
    w = np.moveaxis(w.copy(), axis, -1)
    big = np.abs(w) > 1e-6
    last = (w.shape[-1] - 1 - big[..., ::-1].argmax(-1))[..., None]
    outer = np.take_along_axis(w, last, -1)
    np.put_along_axis(w, last, np.where(np.abs(outer) < 0.1, 0.0, outer), -1)
    return np.moveaxis(w, -1, axis)


def program(x: torch.Tensor, out_shape, weights=None, mid=None) -> torch.Tensor:
    """The port's plain bf16 arithmetic on its own plan
    (``fused_resample_reference``'s: sums in tap order, one fp32 rounding a
    tap), with the weights ``(wv, wh)`` and the intermediate's rounding
    ``mid`` given in place of the port's."""
    nc, h, w = x.shape
    plan = rc.fused_plan(cfg_of((h, w), out_shape))
    wv, wh = weights or rc.plan_weights(plan, "bf16")
    first_v, taps_v = rc.compact_runs(wv)
    rows = (plan.starts_v.astype(np.int64)[:, None] + first_v).reshape(-1)
    first_h, taps_h = rc.compact_runs(np.swapaxes(wh, 1, 2))
    cols = (plan.starts_h.astype(np.int64)[:, None] + first_h[plan.uniq_h]).reshape(-1)
    taps_v = taps_v.reshape(-1, taps_v.shape[-1])
    taps_h = taps_h[plan.uniq_h].reshape(-1, taps_h.shape[-1])
    xf = torch.zeros((nc, max(h, rows.max() + taps_v.shape[1]),
                      max(w, cols.max() + taps_h.shape[1])))
    xf[:, :h, :w] = x
    m = rc._tap_pass(xf, torch.from_numpy(rows), torch.from_numpy(taps_v), 1)
    m = (mid or (lambda v: v.to(torch.bfloat16).float()))(m)
    y = rc._tap_pass(m, torch.from_numpy(cols), torch.from_numpy(taps_h), 2)
    return torch.trunc(torch.clamp(y[:, :out_shape[0], :out_shape[1]], 0, 255)).to(torch.uint8)


def test_the_fault_harness_unbroken_is_the_port():
    x = frame("noise", FAULT_SHAPES[0], 11)
    port = planar(x, FAULT_SHAPES[1]).reshape(-1, *FAULT_SHAPES[1])
    assert torch.equal(program(x.reshape(-1, *FAULT_SHAPES[0]), FAULT_SHAPES[1]), port)


def _fault(name: str, x: torch.Tensor) -> torch.Tensor:
    (h, w), out_shape = FAULT_SHAPES
    if name == "fp32":
        return planar(x, out_shape, "fp32")
    x = x.reshape(-1, h, w)
    plan = rc.fused_plan(cfg_of((h, w), out_shape))
    if name == "weights-rounded-tap-by-tap":
        near = [torch.from_numpy(m).to(torch.bfloat16).float().numpy() for m in (plan.wv, plan.wh)]
        return program(x, out_shape, weights=near)
    if name == "intermediate-7-bit":
        return program(x, out_shape, mid=lambda v: _round_bits(v, 7))
    wv, wh = rc.plan_weights(plan, "bf16")
    return program(x, out_shape, weights=(_drop_outer(wv, 2), _drop_outer(wh, 1)))


@pytest.mark.parametrize("name", ["fp32", "weights-rounded-tap-by-tap", "intermediate-7-bit",
                                  "outer-tap-dropped"])
def test_broken_bf16_arithmetic_reads_above_the_limit(name):
    x = frame("noise", FAULT_SHAPES[0], 13)
    assert gap(_fault(name, x), x) > LIMIT
