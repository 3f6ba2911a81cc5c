"""LongCat-Flash's ScMoE double-layer (``workloads/scmoe.py::ScMoEStep``)
and the kernel's table of rows per (source, destination) pair
(``kernels/moe_dispatch.py::pair_table``), on the CPU at a tiny size: d 64,
expert f 64, dense 128, 16 FFN + 8 zero experts, top-6, 8 ranks. Every
build (host, STREAM_SPLIT, the kernel's plain version) is held to the
plain reference ``models/longcat_ref.py``, which imports nothing of the
port."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import telemetry
from repro_torch.core.design_space import CONSERVATIVE, EXPERT_SYSTEMS
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import moe_dispatch as kern
from repro_torch.models import longcat_ref
from repro_torch.workloads import get_workload
from repro_torch.workloads.scmoe import record_routes

TINY = dict(n_dev=8, tokens_per_rank=16, d=64, f=64, f_dense=128,
            n_experts=16, n_zero=8, topk=6)
CFG = dict(n_experts=16, topk=6, scale=6.0, eps=1e-5)
POINTS = dict(EXPERT_SYSTEMS, CONSERVATIVE=CONSERVATIVE)


def _step(**kw):
    return get_workload("scmoe_step", **dict(TINY, **kw))


def _inputs(w, seed=3, bias=None):
    x = list(w.example_inputs(seed, VirtualMesh(w.n_dev, device="cpu")))
    if bias is not None:
        x[2] = bias
    return x


def _layer(x):
    return dict(zip(longcat_ref.LAYER_KEYS, x[1:]))


def _tables(w, x, point="FLUX"):
    """Run the kernel build on ``x``, recording each launch's counts."""
    seen = []
    real = kern.moe_dispatch_combine

    def spy(*a, counts, **k):
        seen.append(np.asarray(counts))
        return real(*a, counts=counts, **k)
    try:
        kern.moe_dispatch_combine = spy
        with record_routes() as routes:
            out = w.build(POINTS[point], VirtualMesh(w.n_dev, device="cpu"))(
                *x)
    finally:
        kern.moe_dispatch_combine = real
    return out, seen, routes


# ---------------------------------------------------------------- the table


@pytest.mark.parametrize("counts", [[64] * 4, [174, 57, 19, 6],
                                    [128, 0, 0, 0], [1, 0, 127, 0],
                                    [30, 31, 32, 33, 34, 35, 36, 37]])
@pytest.mark.parametrize("tight", [True, False])
def test_equal_rows_build_the_old_schedule(counts, tight):
    """Rows per expert (the skew law's, every source alike) give each
    source the schedule's counts and blocks, so the kernel's loops and its
    CTA split are the schedule's; the same rows written as an n x n table
    give the same microblocks."""
    sched = kern.make_schedule(counts, 64, tight)
    table = kern.pair_table(counts, 64, tight)
    n = len(counts)
    assert table.n == n
    assert table.counts == (sched.counts,) * n
    assert table.blocks == (tuple(sched.blocks),) * n
    assert table.b_max == sched.b_max
    assert all(table.offsets(s) == kern._offsets(counts) for s in range(n))
    for shared in (None, (256, 2048)):
        assert kern.rank_ctas(264, table, 1024, shared) \
            == kern.rank_ctas(264, sched, 1024, shared)
    square = kern.pair_table(np.tile(counts, (n, 1)), 64, tight)
    assert square.counts == table.counts and square.blocks == table.blocks
    assert kern.rank_ctas(264, square, 1024) == kern.rank_ctas(264, sched,
                                                               1024)


def test_pair_table_sizes_each_pair_tight_or_padded():
    counts = [[3, 0, 70], [0, 0, 0], [64, 65, 1]]
    tight = kern.pair_table(counts, 64)
    assert tight.blocks == ((1, 0, 2), (0, 0, 0), (1, 2, 1))
    assert tight.b_max == 2 and tight.rows(2) == 130
    assert tight.offsets(0) == [0, 3, 3]
    # expert 1 computes every source's microblocks: 0 + 0 + 2 of 64 rows
    assert [tight.expert_rows(e) for e in range(3)] == [128, 128, 192]
    assert kern.pair_table(counts, 64, tight=False).blocks == ((2,) * 3,) * 3
    for bad in ([[1, 2]], [[1, -1], [0, 0]], [[[1]]]):
        with pytest.raises(ValueError, match="n x n table"):
            kern.pair_table(bad)


def test_packed_table_prices_each_experts_arrivals_once():
    """Packed (the tile-fused kernel on a tight pair table), expert e's
    GEMMs cover ceil(its rows / 64) microblocks; a table of rows per
    expert and a padded table stay unpacked; the CTA split follows."""
    counts = [[3, 0, 70], [0, 0, 0], [64, 65, 1]]
    packed = kern.pair_table(counts, 64, packed=True)
    assert packed.packed and packed.blocks == kern.pair_table(counts).blocks
    assert [packed.expert_rows(e) for e in range(3)] == [128, 128, 128]
    assert not kern.pair_table(counts, 64, tight=False, packed=True).packed
    assert not kern.pair_table([64, 0, 64], 64, packed=True).packed
    # arrival order e, e + 1, ...: into expert 2, source 2 first
    assert [packed.packed_start(s, 2) for s in range(3)] == [1, 71, 0]
    assert kern.rank_ctas(264, packed, 1024) \
        != kern.rank_ctas(264, kern.pair_table(counts), 1024)


@pytest.mark.parametrize("counts", [
    [[30, 0, 17, 64, 65, 1, 0, 9], [12] * 8, [0] * 8, [200] + [0] * 7,
     [1, 2, 3, 4, 5, 6, 7, 8], [64, 64, 0, 64, 0, 0, 0, 8],
     [0, 50, 0, 50, 0, 50, 0, 50], [25] * 7 + [24]],
    [[128, 113, 147, 130], [110, 129, 127, 140], [0, 0, 0, 0],
     [63, 1, 64, 65]]])
def test_packed_rounds_fill_each_microblock_and_return_each_row(counts):
    """The kernel's packed index arithmetic, step for step: each source's
    run into e in chunks cut at e's microblock edges (the chunk that ends
    e's rows adds the padding) brings every microblock's flag to 64 and
    writes each arrival row once; the combine's walk over a microblock's
    token rows, sources in arrival order, gives each (source, row) back
    once."""
    t = kern.pair_table(counts, 64, packed=True)
    n, B = t.n, t.block_tokens
    for e in range(n):
        R = sum(t.counts[s][e] for s in range(n))
        flags, written = [0] * (n * t.b_max), [0] * R
        for s in range(n):
            c, p0 = t.counts[s][e], t.packed_start(s, e)
            k0 = 0
            while k0 < c:
                J = (p0 + k0) // B
                k1 = min(c, (J + 1) * B - p0)
                flags[J] += k1 - k0 + ((J + 1) * B - R if p0 + k1 == R
                                       else 0)
                for k in range(k0, k1):
                    written[p0 + k] += 1
                k0 = k1
        nb = -(-R // B)
        assert flags[:nb] == [B] * nb and not any(flags[nb:])
        assert written == [1] * R and nb * B == t.expert_rows(e)
        back = {}
        for J in range(nb):
            p, valid, a = J * B, min(R - J * B, B), 0
            for off in range(n):
                s = (e + off) % n
                c = t.counts[s][e]
                for r in range(max(a, p), min(a + c, p + valid)):
                    back[(s, r - a)] = back.get((s, r - a), 0) + 1
                a += c
        assert back == {(s, k): 1 for s in range(n)
                        for k in range(t.counts[s][e])}


def _per_row(x, w1, w2, table):
    want = torch.zeros_like(x)
    for s in range(table.n):
        for e, (off, c) in enumerate(zip(table.offsets(s), table.counts[s])):
            for r in range(off, off + c):
                want[s, r] = kern.swiglu_ffn(x[s, r:r + 1], w1[e], w2[e])[0]
    return want


@pytest.mark.parametrize("wire_i8", [False, True])
def test_kernel_reference_takes_a_pair_table(wire_i8):
    """The kernel's plain version on a table: each source's runs through
    their expert, one row at a time alike; rows past a source's runs come
    back zero; a rank that receives no row (expert 2) and one that sends
    none (source 1) are fine."""
    g = torch.Generator().manual_seed(1)
    n, T, d, f = 4, 40, 64, 64
    x = torch.randn((n, T, d), generator=g)
    w1 = torch.randn((n, d, 2 * f), generator=g) / 8
    w2 = torch.randn((n, f, d), generator=g) / 8
    s1, s2 = torch.randn((d, 2 * f), generator=g) / 8, \
        torch.randn((f, d), generator=g) / 8
    counts = [[5, 0, 0, 30], [0, 0, 0, 0], [1, 2, 0, 3], [10, 10, 0, 20]]
    table = kern.pair_table(counts)
    y, ys = kern.moe_dispatch_combine(x, w1, w2, counts=counts,
                                      wire_i8=wire_i8, shared=(x, s1, s2))
    rows = x
    if wire_i8:
        q, sc = kern.quant_i8(x)
        rows = q.to(torch.float32) * sc
    assert torch.allclose(y, _per_row(rows, w1, w2, table), atol=1e-5)
    assert not y[1].any() and not y[0, 35:].any() and not y[2, 6:].any()
    assert torch.allclose(ys, kern.swiglu_ffn(x, s1, s2))
    with pytest.raises(ValueError, match="do not route"):
        kern.moe_dispatch_combine(x, w1, w2, counts=[[41, 0, 0, 0]] * 4)
    with pytest.raises(ValueError, match="do not route"):
        kern.moe_dispatch_combine(x, w1, w2, counts=[20, 0, 0, 0])


# ------------------------------------------------------------- the layer


@pytest.mark.parametrize("point", sorted(POINTS))
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_every_build_matches_the_reference(point, seed):
    """Host, STREAM_SPLIT and the kernel's points (on the CPU, its plain
    version with the pair table) against ``models/longcat_ref.py``."""
    w = _step()
    x = _inputs(w, seed)
    want, picks, gap = longcat_ref.double_layer(x[0], _layer(x), **CFG)
    with record_routes() as routes:
        got = w.build(POINTS[point], VirtualMesh(8, device="cpu"))(*x)
    assert torch.equal(routes[0], picks) and gap == 0.0
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(w.reference(*x), want)


def test_the_rows_dispatched_are_the_ffn_picks():
    """Each source sends one row for each of its FFN picks to the rank
    that holds the expert (j mod 8), and nothing for a zero pick."""
    w = _step()
    x = _inputs(w)
    _, seen, routes = _tables(w, x)
    table, picks = seen[0], routes[0]
    assert table.shape == (8, 8)
    for s in range(8):
        ffn = picks[s][picks[s] < 16]
        assert table[s].sum() == ffn.numel()
        assert table[s].tolist() == torch.bincount(ffn % 8,
                                                   minlength=8).tolist()
    assert 0 < table.sum() < picks.numel()


def test_every_pick_zero_dispatches_no_row():
    """A bias that sends every pick to a zero expert: an empty table, and
    m = 6 * sum of g u, so out = h1 + FFN2(RMSNorm1(h1)) + 6 (sum g) u."""
    w = _step()
    bias = torch.zeros(24)
    bias[16:] = 100.0
    x = _inputs(w, bias=bias)
    got, seen, routes = _tables(w, x)
    assert not seen[0].any() and (routes[0] >= 16).all()
    want = longcat_ref.double_layer(x[0], _layer(x), **CFG)[0]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    lay = _layer(x)
    u = longcat_ref.rms_norm(x[0], lay["g0"], 1e-5)
    s = longcat_ref.scores(u, lay["wr"])
    g = 6.0 * s.gather(-1, routes[0]).sum(-1, keepdim=True)
    h1 = x[0] + longcat_ref.swiglu(u, lay["s1"], lay["s2"])
    tail = longcat_ref.swiglu(longcat_ref.rms_norm(h1, lay["g1"], 1e-5),
                              lay["t1"], lay["t2"])
    assert torch.allclose(got, h1 + tail + g * u, atol=1e-5)


def test_a_rank_that_receives_no_row():
    """FFN experts 3 and 11 (rank 3's) never picked: rank 3 receives no
    row, and the layer still matches."""
    w = _step()
    bias = torch.zeros(24)
    bias[[3, 11]] = -100.0
    x = _inputs(w, bias=bias)
    got, seen, _ = _tables(w, x)
    assert not seen[0][:, 3].any() and seen[0].sum() > 0
    want = longcat_ref.double_layer(x[0], _layer(x), **CFG)[0]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_two_picks_of_one_token_on_one_rank_are_two_rows():
    """Experts 2 and 10 share rank 2's tensor; a bias makes every token
    pick both: each is a row of its own (rank 2 gets at least 2 T rows
    from each source), and each is computed."""
    w = _step()
    bias = torch.zeros(24)
    bias[[2, 10]] = 100.0
    x = _inputs(w, bias=bias)
    got, seen, routes = _tables(w, x)
    both = ((routes[0] == 2).any(-1) & (routes[0] == 10).any(-1))
    assert both.all()
    assert (seen[0][:, 2] >= 2 * 16).all()
    want = longcat_ref.double_layer(x[0], _layer(x), **CFG)[0]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_the_tied_layer_is_the_uncut_reference_with_tied_weights():
    """The chip's share, 8 tensors for 16 FFN experts, against the uncut
    reference whose expert j has its own weights W[j mod 8]: the same
    layer, bit for bit, and the program matches both."""
    w = _step()
    x = _inputs(w)
    lay = _layer(x)
    whole = dict(lay, w1=torch.cat([lay["w1"]] * 2),
                 w2=torch.cat([lay["w2"]] * 2))
    cut = longcat_ref.double_layer(x[0], lay, **CFG)[0]
    uncut = longcat_ref.double_layer(x[0], whole, **CFG)[0]
    assert torch.equal(cut, uncut)
    got = w.build(EXPERT_SYSTEMS["FLUX"], VirtualMesh(8, device="cpu"))(*x)
    assert (got - uncut).abs().max() <= 1e-5 * uncut.abs().max()


def test_route_gap_reads_a_pick_off_the_top():
    g = torch.Generator().manual_seed(2)
    s = torch.softmax(torch.randn((5, 24), generator=g), -1)
    b = torch.zeros(24)
    own = longcat_ref.route(s, b, 6)
    assert longcat_ref.route_gap(s, b, own) == 0.0
    order = torch.topk(s, 7, -1).indices
    swapped = torch.cat([order[:, :5], order[:, 6:7]], -1)
    gap = longcat_ref.route_gap(s, b, swapped)
    want = (s.gather(-1, order[:, 5:6]) - s.gather(-1, order[:, 6:7])).max()
    assert gap == pytest.approx(float(want)) and gap > 0


def test_spans_sit_beside_the_kernels_call_and_notes_count_a_launch():
    """Under a profiler: ``scmoe.route``, ``scmoe.combine`` and
    ``scmoe.ffn2`` once a call, each outermost (never around the kernel
    entry's span), none ending in ``.call``; one set of notes a launch."""
    telemetry.reset()
    w = _step()
    x = _inputs(w)
    run = w.build(EXPERT_SYSTEMS["FLUX"], VirtualMesh(8, device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        with record_routes() as routes:
            run(*x)
            run(*x)
    got = [(name, parent) for name, _, parent, _, _ in telemetry.spans()]
    assert got == [("scmoe.route", None), ("scmoe.combine", None),
                   ("scmoe.ffn2", None)] * 2
    rows = int((routes[0] < 16).sum())
    notes = [(name, v) for name, v, _ in telemetry.notes()]
    assert notes == [("scmoe.ffn_rows", rows),
                     ("scmoe.zero_picks", routes[0].numel() - rows),
                     ("scmoe.max_pair", pytest.approx(notes[2][1]))] * 2
    assert notes[2][1] >= rows / 64
    telemetry.collect()
    assert telemetry.TRACE.histogram("scmoe.ffn_rows").count == 2
    telemetry.reset()
    run(*x)                      # no profiler: nothing kept
    assert telemetry.spans() == [] and telemetry.notes() == []


def test_cost_breakdown_prices_ffn1_against_the_dispatch():
    w = get_workload("scmoe_step")
    assert list(w._counts(w.T)) == [128] * 8
    hw = extract_hardware_context(VirtualMesh(8, device="cpu"), H100)
    flux = w.cost_breakdown(EXPERT_SYSTEMS["FLUX"], hw)
    assert flux.meta["path"] == "kernel_two_stream"
    span = flux.segments[0]
    assert span.name == "two_stream_span" and span.meta["compute_s"] > \
        span.meta["wire_s"]
    host = w.cost_breakdown(CONSERVATIVE, hw)
    assert host.meta["path"] == "xla_host"
    assert w.analytic_cost(EXPERT_SYSTEMS["FLUX"], hw) == flux.total \
        < host.total
    assert w.collective_schedule(EXPERT_SYSTEMS["FLUX"]).counts == (128,) * 8
    with pytest.raises(NotImplementedError, match="rank j mod n"):
        w.degrade((0, 1, 2))
