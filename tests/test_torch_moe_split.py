"""The moe_dispatch kernel's CTA split (``kernels/moe_dispatch.py``): the
wrapper gives each rank's routed stream (and second stream) CTAs of the
one cooperative launch in proportion to its work, and passes the prefix
table the kernel reads. Plain Python, so it runs here on the CPU; the
card-side use is held by ``tests/test_torch_gpu.py``."""
import numpy as np
import pytest

from repro_torch.kernels import moe_dispatch as kern


@pytest.mark.parametrize("grid", [4, 7, 66, 264, 265])
@pytest.mark.parametrize("work", [[1, 1, 1, 1], [696, 228, 76, 24],
                                  [0, 0, 5, 0], [0, 0, 0, 0], [3, 0, 1, 9]])
def test_split_sums_to_the_grid_and_meets_every_minimum(grid, work):
    split = kern.cta_split(grid, work)
    assert len(split) == len(work) and sum(split) == grid
    assert min(split) >= 1


@pytest.mark.parametrize("grid,k", [(264, 4), (263, 4), (264, 8), (9, 8),
                                    (132, 3)])
def test_split_is_even_under_uniform_work(grid, k):
    split = kern.cta_split(grid, [7] * k)
    assert max(split) - min(split) <= 1
    assert split == sorted(split, reverse=True)   # ties to earlier streams


def test_split_follows_the_work():
    # the skewed cell: 4 ranks x (174, 57, 19, 6) rows to experts 0..3
    split = kern.cta_split(264, [4 * c for c in (174, 57, 19, 6)])
    assert split == [178, 59, 20, 7]
    # a rank whose expert gets no row still gets its one CTA
    assert kern.cta_split(264, [1024, 0, 0, 0]) == [261, 1, 1, 1]


def test_split_is_monotone_in_the_work():
    rng = np.random.default_rng(0)
    for _ in range(300):
        k = int(rng.integers(1, 9))
        work = [int(w) for w in rng.integers(0, 500, k)]
        grid = int(rng.integers(k, 400))
        split = kern.cta_split(grid, work)
        for i in range(k):          # more work never gets fewer CTAs
            for j in range(k):
                if work[i] > work[j]:
                    assert split[i] >= split[j]
        i = int(rng.integers(k))    # and growing one stream never costs it
        more = list(work)
        more[i] += int(rng.integers(1, 300))
        assert kern.cta_split(grid, more)[i] >= split[i]


def test_split_raises_where_the_grid_is_too_small():
    with pytest.raises(ValueError, match="cannot give"):
        kern.cta_split(3, [1, 1, 1, 1])
    with pytest.raises(ValueError, match="cannot give"):
        kern.rank_ctas(7, kern.make_schedule([64] * 4), 2048,
                       shared=(256, 2048))
    with pytest.raises(ValueError, match="work >= 0"):
        kern.cta_split(8, [1, -1])


def test_rank_ctas_weighs_routed_and_second_stream_work():
    # serving: 4 x 64 rows to each expert at f = 2048 against 256 rows of
    # the shared expert at fs = 2048: equal work, an even split
    ctas = kern.rank_ctas(264, kern.make_schedule([64] * 4), 2048,
                          shared=(256, 2048))
    assert ctas == [(33, 33)] * 4
    assert kern.stream_starts(ctas) == [0, 33, 66, 99, 132, 165, 198, 231,
                                        264]
    # a wider shared expert takes more of the grid
    routed, second = kern.rank_ctas(264, kern.make_schedule([64] * 4), 2048,
                                    shared=(256, 4096))[0]
    assert second > routed >= 1


def test_rank_ctas_gives_every_second_stream_the_same_ctas():
    """Second streams of equal work take equal CTAs, the whole CTAs of
    their share: LongCat's cell (8 ranks, about 20 microblocks of 64 rows
    into each at f = 2048, 128 rows of FFN1 at 12288) gives each 12 of its
    12.45; the routed streams split the other 168 by their work."""
    counts = [[126, 130, 120, 129, 131, 128, 125, 135]] * 8
    table = kern.pair_table(counts)
    ctas = kern.rank_ctas(264, table, 2048, shared=(128, 12288))
    assert [s for _, s in ctas] == [12] * 8
    routed = [r for r, _ in ctas]
    assert sum(routed) == 168
    assert routed == kern.cta_split(168, [table.expert_rows(e) * 2048
                                          for e in range(8)])
    # no routed row at all: every routed stream keeps one CTA
    empty = kern.rank_ctas(264, kern.pair_table([[0] * 4] * 4), 2048,
                           shared=(48, 256))
    assert empty == [(1, 65)] * 4


def test_rank_ctas_counts_the_rows_the_kernel_computes():
    """The skewed cell: (174, 57, 19, 6) rows a source to experts 0..3 are
    3, 1, 1 and 1 microblocks of 64 rows, and every microblock costs a
    whole GEMM tile, so the routed work is 12 : 4 : 4 : 4 tiles."""
    sched = kern.make_schedule([174, 57, 19, 6], block_tokens=64)
    ctas = kern.rank_ctas(264, sched, 1024)
    # one CTA each, the other 260 by largest remainder: 130 + 43.3 x 3
    assert ctas == [(131, 0), (45, 0), (44, 0), (44, 0)]
    assert kern.stream_starts(ctas) == [0, 131, 131, 176, 176, 220, 220,
                                        264, 264]
    # padded (not tight), every expert gets the largest block count
    padded = kern.make_schedule([174, 57, 19, 6], block_tokens=64,
                                tight=False)
    assert kern.rank_ctas(264, padded, 1024) == [(66, 0)] * 4
    # an expert with no row has no microblock, and keeps its one CTA
    # (it still dispatches its rank's tokens and assembles them)
    empty = kern.make_schedule([128, 0, 0, 0], block_tokens=64)
    assert kern.rank_ctas(264, empty, 1024) == [(261, 0), (1, 0), (1, 0),
                                                (1, 0)]
    # more rows never take CTAs away from an expert
    for grow in range(0, 300, 7):
        more = kern.make_schedule([174 + grow, 57, 19, 6], block_tokens=64)
        assert kern.rank_ctas(264, more, 1024)[0][0] >= ctas[0][0]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("shared", [None, (256, 2048)])
@pytest.mark.parametrize("tile_fused", [False, True])
def test_rank_ctas_at_one_cta_an_sm(n, shared, tile_fused):
    """The wgmma core's grid, 132 CTAs (one an SM): every rank keeps a
    routed CTA, every second stream the same share, and the prefix table
    covers the grid, under uniform, skewed and empty routing."""
    for counts in ([64] * n, [64 * (n - e) ** 2 for e in range(n)],
                   [512] + [0] * (n - 1)):
        sched = kern.make_schedule(counts)
        ctas = kern.rank_ctas(132, sched, 2048, shared, tile_fused)
        assert len(ctas) == n and sum(map(sum, ctas)) == 132
        assert min(r for r, _ in ctas) >= 1
        assert len({s for _, s in ctas}) == 1
        assert (ctas[0][1] >= 1) is (shared is not None)
        starts = kern.stream_starts(ctas)
        assert starts[0] == 0 and starts[-1] == 132
        assert starts == sorted(starts) and len(starts) == 2 * n + 1


def test_tile_rows_cut_a_segment_into_tiles_of_128_and_a_tail_of_64():
    assert kern.tile_rows(1) == kern.tile_rows(64) == 64
    assert kern.tile_rows(65) == kern.tile_rows(500) == 128
    assert kern.segment_tiles(64) == [64]
    assert kern.segment_tiles(128) == [128]
    assert kern.segment_tiles(192) == [128, 64]
    assert kern.segment_tiles(200) == [128, 128]
    assert kern.segment_tiles(320) == [128, 128, 64]
    assert kern.segment_tiles(0) == []


def test_token_tiles_count_the_launch_units_by_width():
    """The note on ``moe_dispatch.call``: prefill_skew's schedule (4 ranks
    x (174, 57, 19, 6) rows; 3, 1, 1, 1 microblocks of 64 a source) under
    pipelined SIGNAL takes a 128 and a 64 tile of each source's 3
    microblocks into expert 0 and a 64 tile of every other pair; each tile
    is f / 64 GEMM1 units and d / 128 GEMM2 units."""
    sched = kern.pair_table([174, 57, 19, 6])
    per = 1024 // 64 + 512 // 128
    assert kern.token_tiles(sched, 1024, 512, tile_fused=False) \
        == {128: 4 * per, 64: (4 + 4 * 3) * per}
    # tile-fused: every microblock one 64-row tile
    assert kern.token_tiles(sched, 1024, 512, tile_fused=True) \
        == {128: 0, 64: 4 * 6 * per}
    # the second stream's Ts rows: 300 = 128 + 128 + 44 (a 64 tile), a rank
    assert kern.token_tiles(sched, 1024, 512, tile_fused=True,
                            shared=(300, 2048)) \
        == {128: 4 * 2 * (2048 // 64 + 4), 64: 4 * 6 * per + 4 * (32 + 4)}
    # packed: an expert's arrivals in ceil(rows / 64) microblocks: 104
    # rows into expert 0 take 2, 64 into expert 1 take 1
    packed = kern.pair_table([[40, 63], [64, 1]], packed=True)
    assert kern.token_tiles(packed, 128, 128, tile_fused=True) \
        == {128: 0, 64: (2 + 1) * (2 + 1)}
    assert kern.computed_rows(packed, 0, True) == 128
    assert kern.computed_rows(kern.pair_table([174, 57, 19, 6]), 0, False) \
        == 4 * 192
