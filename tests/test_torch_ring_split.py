"""The ring_attention kernel's CTA split (``kernels/ring_attention.py``):
the wrapper gives each rank CTAs of the one cooperative launch by its
causal work and passes the prefix table the kernel reads. Plain Python,
so it runs here on the CPU; the card-side use is held by
``tests/test_torch_gpu_attention.py::test_ring_launches_its_ctas_by_causal_work``.
"""
import itertools
import os
import sys

import numpy as np
import pytest

from repro_torch.kernels import moe_dispatch, split
from repro_torch.kernels import ring_attention as ra

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import chip_smoke  # noqa: E402

SHAPES = [(4, 8, 1024), (4, 96, 2048), (2, 3, 200), (3, 2, 100), (8, 4, 512),
          (1, 8, 4096), (4, 1, 64)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("grid", [8, 132, 264, 396, 528])
@pytest.mark.parametrize("n,BH,Sl", SHAPES)
def test_split_sums_to_the_grid_and_gives_every_rank_a_cta(n, BH, Sl, grid,
                                                           causal):
    ctas = ra.ring_ctas(grid, n, BH, Sl, causal)
    assert len(ctas) == n and sum(ctas) == grid and min(ctas) >= 1


@pytest.mark.parametrize("grid", [8, 132, 264, 396, 528])
@pytest.mark.parametrize("n,BH,Sl", SHAPES)
def test_split_is_even_without_the_mask_and_rises_with_r_under_it(n, BH, Sl,
                                                                  grid):
    even = ra.ring_ctas(grid, n, BH, Sl, causal=False)
    assert max(even) - min(even) <= 1
    causal = ra.ring_ctas(grid, n, BH, Sl, causal=True)
    assert causal == sorted(causal)


def test_split_gives_the_last_rank_more_than_the_first():
    # RingAttention's defaults and fig3's largest row, f32 and bf16 grids
    for grid in (264, 396):
        for BH, Sl in ((8, 1024), (96, 2048)):
            ctas = ra.ring_ctas(grid, 4, BH, Sl)
            assert ctas[-1] > 2 * ctas[0]


def test_split_raises_where_the_grid_is_too_small():
    with pytest.raises(ValueError, match="cannot give 4 ranks"):
        ra.ring_ctas(3, 4, 8, 1024)
    assert ra.ring_ctas(4, 4, 8, 1024) == [1, 1, 1, 1]


def brute_force_work(n, BH, Sl, causal):
    """(64-row q tile, 64-row key tile) pairs each rank attends over its
    n steps, from the mask itself: a pair counts when any of its queries
    may see any of its keys (a ragged edge is a whole tile), times BH."""
    rows = np.arange(Sl)
    tile = rows // 64
    nt = int(tile[-1]) + 1
    work = []
    for r in range(n):
        pairs = 0
        for s in range(n):
            src = (r - s) % n
            qpos = r * Sl + rows
            kpos = src * Sl + rows
            see = qpos[:, None] >= kpos[None, :] if causal else \
                np.ones((Sl, Sl), bool)
            hit = np.zeros((nt, nt), bool)
            np.logical_or.at(hit, (tile[:, None], tile[None, :]), see)
            pairs += int(hit.sum())
        work.append(BH * pairs)
    return work


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,BH,Sl", [(4, 2, 256), (4, 1, 200), (3, 3, 100),
                                     (2, 1, 64), (5, 2, 130), (1, 2, 90)])
def test_work_is_the_unmasked_tile_pairs(n, BH, Sl, causal):
    assert ra.ring_work(n, BH, Sl, causal) == brute_force_work(n, BH, Sl,
                                                               causal)


@pytest.mark.parametrize("grid", [132, 264, 396])
@pytest.mark.parametrize("n,BH,Sl", [(4, 8, 1024), (4, 96, 2048),
                                     (8, 4, 512), (2, 3, 200)])
def test_split_is_no_slower_than_the_proportional_one(n, BH, Sl, grid):
    """The model the split minimises (whole pieces, the credit and
    arrival waits) rates it at least as fast as the split in proportion
    to the attended pairs and as the even split; faster than the even
    split where a rank has more pieces than CTAs."""
    ctas = ra.ring_ctas(grid, n, BH, Sl)
    by_pairs = split.cta_split(grid, ra.ring_work(n, BH, Sl))
    even = split.cta_split(grid, [1] * n)
    t = ra.ring_makespan(tuple(ctas), n, BH, Sl)
    assert t <= ra.ring_makespan(tuple(by_pairs), n, BH, Sl)
    t_even = ra.ring_makespan(tuple(even), n, BH, Sl)
    assert t <= t_even
    if BH * -(-Sl // 64) > grid // n:
        assert t < t_even


def test_makespan_counts_whole_pieces():
    # one rank, one bh, 4 query tiles of 2.5 diagonal key tiles each on
    # average: one piece a CTA on 4 CTAs, all four on one
    assert ra.ring_makespan((4,), 1, 1, 256) == 2.5
    assert ra.ring_makespan((3,), 1, 1, 256) == 2 * 2.5
    assert ra.ring_makespan((1,), 1, 1, 256) == 4 * 2.5
    # without the mask each rank attends n whole shards
    assert ra.ring_makespan((16, 16), 2, 1, 256, causal=False) == 2 * 4


def test_the_split_is_shared_with_moe_dispatch():
    assert moe_dispatch.cta_split is split.cta_split


@pytest.mark.parametrize("grid", [132, 264, 396])
@pytest.mark.parametrize("n,BH,Sl", [(4, 8, 1024), (4, 96, 2048),
                                     (8, 4, 512), (2, 3, 200)])
def test_chip_smoke_splits_fill_the_grid(n, BH, Sl, grid):
    """Phase ``ring_split``'s splits: each fills the grid with one CTA a
    rank at least, rises with r under the mask, and ``ring_ctas`` is
    among them; the closed form leaves no CTA where moving it would
    lower the busiest rank's tile pairs."""
    cands = chip_smoke.split_candidates(grid, n, BH, Sl)
    assert list(cands) == ["ring_ctas", "pairs", "even", "balanced"]
    assert cands["ring_ctas"] == ra.ring_ctas(grid, n, BH, Sl)
    for ctas in cands.values():
        assert len(ctas) == n and sum(ctas) == grid and min(ctas) >= 1
    for name in ("pairs", "balanced"):
        assert cands[name] == sorted(cands[name])
    pieces = BH * -(-Sl // 64)
    per_piece = [w / pieces for w in ra.ring_work(n, BH, Sl)]

    def busiest(ctas):
        return max(-(-pieces // c) * w for c, w in zip(ctas, per_piece))

    best = busiest(cands["balanced"])
    for i, j in itertools.permutations(range(n), 2):
        moved = list(cands["balanced"])
        moved[i] -= 1
        moved[j] += 1
        if moved[i] >= 1:
            assert busiest(moved) >= best


def test_chip_smoke_split_phase_skips_on_the_cpu():
    assert chip_smoke.phase_ring_split("cpu") == {}
