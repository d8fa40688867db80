"""``lanczos_torch.ops._fma``: fp32 ``acc + w·x`` rounded once a tap
(``fma_tap``), and chains of such taps (``fma_sum``).

Held to a correctly rounded reference on seeded operands: exact
``fractions.Fraction`` arithmetic rounded to the nearest fp32, ties to
even, on every Python.  (``math.fma``, from Python 3.13, rounds to
float64; rounding its result again to fp32 is the double rounding under
test, so it cannot stand as the reference.)  The operands include ties
that a float64 sum rounded straight to fp32 gets wrong, and sums below
fp32's normal range.
:func:`fma32` is the same rounding in numpy, for the tests that re-enact
the kernels' loops.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lanczos_torch.ops._fma import fma_sum, fma_tap  # noqa: E402


def fma32(acc, w, x):
    """fp32 ``acc + w·x`` rounded once, in numpy: the float64 product is
    exact, the float64 sum is rounded to odd (TwoSum's error term), then
    to the nearest fp32."""
    a = np.asarray(acc, np.float32).astype(np.float64)
    p = np.asarray(w, np.float32).astype(np.float64) * np.asarray(x, np.float32).astype(np.float64)
    s = np.asarray(a + p, np.float64)
    bb = s - a
    err = (a - (s - bb)) + (p - bb)
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _round_f32(q: Fraction) -> np.float32:
    """The fp32 nearest the rational ``q``, ties to even."""
    f = np.float32(float(q))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - q)
        key = (d, int(np.float32(c).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return np.float32(best[1])


def _correctly_rounded(acc, w, x) -> np.ndarray:
    return np.array([
        _round_f32(Fraction(float(a)) + Fraction(float(b)) * Fraction(float(c)))
        for a, b, c in zip(acc, w, x)
    ], np.float32)


def _operands(n: int, seed: int):
    rng = np.random.default_rng(seed)
    acc = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    x = rng.integers(0, 256, n).astype(np.float32)
    # ties: |acc| in [1, 2) with an odd last bit, w·x = 2^-24·(1 - 2^-46), just below
    # half an ulp of acc: a float64 sum lands on the fp32 midpoint and rounds to even
    # (up), the single rounding goes down
    m = n // 4
    sgn = np.where(rng.integers(0, 2, m) == 1, 1.0, -1.0)
    mant = rng.integers(0, 2**22, m) * 2 + 1 + 2**23
    acc[:m] = (sgn * mant * 2.0**-23).astype(np.float32)
    w[:m] = np.float32((1 + 2.0**-23) * 2.0**-24)
    x[:m] = (sgn * (1 - 2.0**-23)).astype(np.float32)
    # sums below fp32's normal range (2^-126), where fewer bits are kept
    sub = slice(m, m + n // 8)
    k = n // 8
    acc[sub] = (rng.standard_normal(k) * 2.0**-130).astype(np.float32)
    w[sub] = (rng.standard_normal(k) * 2.0**-70).astype(np.float32)
    x[sub] = (rng.standard_normal(k) * 2.0**-60).astype(np.float32)
    return acc, w, x, m


@pytest.mark.parametrize("seed", [0, 1])
def test_fma_tap_is_correctly_rounded(seed):
    acc, w, x, m = _operands(2000, seed)
    want = _correctly_rounded(acc, w, x)
    got = fma_tap(torch.from_numpy(acc), torch.from_numpy(w), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(fma32(acc, w, x).view(np.int32), want.view(np.int32))
    # a float64 sum rounded straight to fp32 misses every tie: the ties are real
    twice = (acc.astype(np.float64) + w.astype(np.float64) * x.astype(np.float64)).astype(np.float32)
    assert (twice[:m].view(np.int32) != want[:m].view(np.int32)).all()


def test_fma_tap_first_tap_python_weight_and_broadcast():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (3, 5, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 5, 1)).astype(np.float32))
    first = fma_tap(None, w, x)
    assert torch.equal(first, w * x)  # the rounded product, as fmaf(w, x, 0)
    acc = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
    got = fma_tap(acc, w, x)
    want = fma32(acc.numpy(), np.broadcast_to(w.numpy(), x.shape), x.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    wf = float(np.float32(0.3))  # a Python float that fp32 holds exactly
    np.testing.assert_array_equal(fma_tap(acc, wf, x).numpy(), fma32(acc.numpy(), wf, x.numpy()))


def test_fma_tap_passes_gradients():
    rng = np.random.default_rng(4)
    acc = torch.from_numpy(rng.standard_normal(6).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal(6).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal(6).astype(np.float32)).requires_grad_(True)
    ga, gw, gx = torch.autograd.grad(fma_tap(acc, w, x).sum(), (acc, w, x))
    assert torch.equal(ga, torch.ones(6))
    np.testing.assert_allclose(gw.numpy(), x.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), w.detach().numpy(), rtol=1e-6)


def _chain_np(ws, xs):
    acc = (np.float32(ws[0]) * xs[0]).astype(np.float32)
    for w, x in zip(ws[1:], xs[1:]):
        acc = fma32(acc, w, x)
    return acc


@pytest.mark.parametrize("kind", ["noise", "ties", "tiny"])
def test_fma_sum_equals_a_chain_of_single_roundings(kind):
    """``fma_sum`` over 6 taps against :func:`fma32` tap by tap: on seeded
    noise (no element flagged), on taps that put ties in the chain (flagged
    and redone), and on products below 2^-126 (the tiny-partial route)."""
    rng = np.random.default_rng({"noise": 5, "ties": 6, "tiny": 7}[kind])
    n, taps = 4000, 6
    src = rng.integers(0, 256, (taps, n)).astype(np.float32)
    ws = rng.standard_normal((taps, n)).astype(np.float32)
    if kind == "ties":  # tap 1 lands on a midpoint after tap 0 for a quarter of the elements
        m = n // 4
        sgn = np.where(rng.integers(0, 2, m) == 1, 1.0, -1.0)
        ws[0, :m], src[0, :m] = 1.0, (sgn * (rng.integers(0, 2**22, m) * 2 + 1 + 2**23)
                                      * 2.0**-23).astype(np.float32)
        ws[1, :m] = np.float32((1 + 2.0**-23) * 2.0**-24)
        src[1, :m] = (sgn * (1 - 2.0**-23)).astype(np.float32)
        ws[2:, :m] = 0.0
    if kind == "tiny":
        src = (rng.standard_normal((taps, n)) * 2.0**-60).astype(np.float32)
        ws = (rng.standard_normal((taps, n)) * 2.0**-75).astype(np.float32)
    source = torch.from_numpy(src)
    got = fma_sum(lambda t: (torch.from_numpy(ws[t]), source[t]), taps, source,
                  torch.from_numpy(ws)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _chain_np(ws, src).view(np.int32))


def test_fma_sum_python_weights_float64_source_and_gradients():
    rng = np.random.default_rng(8)
    src = torch.from_numpy(rng.integers(0, 256, (4, 300)).astype(np.float32))
    row = [float(np.float32(v)) for v in rng.standard_normal(4)]
    got = fma_sum(lambda t: (row[t], src.double()[t]), 4, src, row)
    np.testing.assert_array_equal(got.numpy(), _chain_np(row, src.numpy()))
    x64 = src.double()
    w64 = torch.from_numpy(rng.standard_normal(4))
    plain = fma_sum(lambda t: (w64[t], x64[t]), 4, x64, w64)  # a float64 sum: its own arithmetic
    want = w64[0] * x64[0]
    for t in range(1, 4):
        want = want + w64[t] * x64[t]
    assert plain.dtype == torch.float64 and torch.equal(plain, want)
    xs = src.clone().requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((4, 1)).astype(np.float32)).requires_grad_(True)
    out = fma_sum(lambda t: (w[t], xs[t]), 4, xs.detach(), w.detach())
    gx, gw = torch.autograd.grad(out.sum(), (xs, w))
    np.testing.assert_allclose(gx.numpy(), np.broadcast_to(w.detach().numpy(), (4, 300)),
                               rtol=1e-6)
    np.testing.assert_allclose(gw.numpy()[:, 0], src.numpy().sum(1), rtol=1e-5)
