"""The fused kernel's vertical thread tiles, mirrored on the CPU.

``csrc/fused_resample.cu``'s ``vertical_pass`` gives each lane a thread
tile of 8 intermediate columns by one row group of 4 tile rows, tile ``t``
of :func:`vertical_tile`: the earlier order with bits 3 and 4 of ``t``
swapped where a tile has a multiple of 16 row groups, so that a half-warp
takes 8 row groups of 2 column groups.  Here that mapping is re-enacted
over a grid of geometries: every intermediate element is written once,
every read stays inside the band, a warp's band loads are half as
conflicted as before on the benchmark's plans, and its 16-byte stores stay
conflict-free.
"""

import numpy as np
import pytest

from lanczos_torch.core.config import ResampleConfig
from lanczos_torch.ops import _build
from lanczos_torch.ops import resample_cuda as rc


def vertical_tile(t: int, tile_p: int) -> tuple:
    """``(column group, row group)`` of the kernel's vertical thread tile
    ``t``: ``divmod(t, tile_p / 4)``, with bits 3 and 4 of ``t`` swapped
    where ``tile_p / 4`` is a multiple of 16."""
    nrg = tile_p // 4
    if nrg % 16 == 0:
        t = (t & ~24) | (t >> 1 & 8) | (t << 1 & 16)
    return divmod(t, nrg)


def warp_tiles(mw: int, tile_p: int, tile=vertical_tile):
    """Per warp-round of 32 tile indices (the kernel's loop runs whole
    warps), each lane's (row group, column group), None where its mapped
    index is past the last tile."""
    nrg = tile_p // 4
    n = (mw // 8) * nrg
    for w0 in range(0, n, 32):
        tiles = []
        for t in range(w0, w0 + 32):
            jg, rg = tile(t, tile_p)
            tiles.append((rg, jg) if jg * nrg + rg < n else None)
        yield tiles


def parent_tile(t: int, tile_p: int) -> tuple:
    """The order before the swap: ``divmod(t, tile_p / 4)``."""
    return divmod(t, tile_p // 4)


def _widths(channels: int, kh: int) -> tuple:
    sizes = rc.smem_layout(8, 1, 16, kh, channels)
    return sizes["mw"], sizes["bw"]


# (channels, mw, bw) of every intermediate up to 256 columns
GEOMETRIES = sorted({(c, *_widths(c, kh)) for c in (1, 3, 4) for kh in range(1, 250)
                     if _widths(c, kh)[0] <= 256})


@pytest.mark.parametrize("tile_p", [8, 16, 24, 32, 40, 64, 96, 128])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_every_intermediate_element_is_written_once(channels, tile_p):
    """Each warp-round takes the tiles it took before the swap, lanes
    permuted (a ragged last round included: a lane whose mapped index is
    past the last tile does nothing), and every tile's reads lie inside
    the band's row."""
    for c, mw, bw in GEOMETRIES:
        if c != channels:
            continue
        written = np.zeros((mw, tile_p), np.int32)
        rounds = zip(warp_tiles(mw, tile_p), warp_tiles(mw, tile_p, parent_tile))
        for tiles, before in rounds:
            assert sorted(t for t in tiles if t) == sorted(t for t in before if t)
            for tile in tiles:
                if tile is None:
                    continue
                rg, jg = tile
                written[8 * jg : 8 * jg + 8, 4 * rg : 4 * rg + 4] += 1
                assert 8 + 8 * jg + 8 <= bw  # past joff (at most 8), inside the band's row
        assert (written == 1).all(), (mw, tile_p)


def _plan_layout(shape, scale, channels):
    cfg = ResampleConfig.from_profile("precise", shape, scale=scale, a=3)
    plan = rc.fused_plan(cfg)
    if channels > 1:
        plan = rc.interleaved_plan(cfg, plan.tile_out, channels)
    return rc.kernel_layout(plan, cfg.precision, channels)


def _load_ways(half, base, bw, s):
    """Wavefronts of one LDS.64 of a half-warp at window step ``s``: the
    most lanes on one bank among the 8-byte words they read that differ."""
    words = {(int(base[rg]) + s) * bw // 8 + jg for rg, jg in half}
    banks = [w % 16 for w in words]
    return max((banks.count(b) for b in set(banks)), default=0)


BENCHMARK_PLANS = [
    ((2160, 3840), (2, 1), 1),  # perf8k-batch4-oncard, perf8k-bf16-batch4-oncard
    ((1440, 2560), (3, 2), 1),
    ((2160, 3840), (2, 1), 3),  # perf8k-video-host
    ((1440, 2560), (3, 2), 3),  # quality4k-batch4-upscale
]


@pytest.mark.parametrize("shape,scale,channels", BENCHMARK_PLANS)
def test_band_loads_are_half_as_conflicted(shape, scale, channels):
    """Every window step of the first tiles of the benchmark's plans: a
    half-warp's band loads are half as conflicted as before the swap
    (2-way against 4-way at 2/1, 3 against 6 at 3/2)."""
    lay = _plan_layout(shape, scale, channels)
    bw, win, mw, tile_p = lay["bw"], lay["win_v"], lay["mw"], lay["tile_p"]
    worst = {}
    for name, tile in (("new", vertical_tile), ("old", parent_tile)):
        worst[name] = max(
            _load_ways([t for t in tiles[h : h + 16] if t is not None], base, bw, s)
            for base in lay["base_v"][:8] for s in range(win)
            for tiles in warp_tiles(mw, tile_p, tile) for h in (0, 16))
    assert (worst["new"], worst["old"]) == ((2, 4) if scale == (2, 1) else (3, 6))


@pytest.mark.parametrize("tile_p", [8, 16, 32, 64, 128])
def test_quarter_warp_stores_fall_on_as_many_banks(tile_p):
    """A quarter-warp's 16-byte stores of one column's four sums fall on as
    many 16-byte bank groups as before the swap: all different wherever a
    tile has 8 row groups or more."""
    def groups(tile):
        for tiles in warp_tiles(80, tile_p, tile):
            for q in range(0, 32, 8):
                quarter = [t for t in tiles[q : q + 8] if t is not None]
                yield len(quarter), len({(8 * jg * tile_p + 4 * rg) // 4 % 8 for rg, jg in quarter})

    new, old = list(groups(vertical_tile)), list(groups(parent_tile))
    assert new == old
    assert tile_p < 32 or all(n == k for n, k in new)


def test_the_kernels_tiles_are_these():
    """The kernel's swap is ``vertical_tile``'s, and its stores are
    16-byte vector stores."""
    src = (_build.CSRC / "fused_resample.cu").read_text()
    assert "const bool swap = (nrg_v & 15) == 0;" in src
    assert "for (int t = tid; t < ((n + 31) & ~31); t += kThreads) {" in src
    assert "const int u = swap ? (t & ~24) | (t >> 1 & 8) | (t << 1 & 16) : t;" in src
    assert "if (u >= n) continue;" in src
    assert "st_shared_v4(mcol + m * tile_p, v[0], v[1], v[2], v[3]);" in src
