"""The send window and its op recorder, on the CPU, against the JAX package.

``kernels/gemm_allgather.py``'s ``probe=`` walks the reference's round
program through the port's ``SendWindow``: its events must pass the
reference's own ``ScheduleProbe.check`` against the reference's
``make_broadcast_schedule`` (contexts 1, 2, 4 x fused x counter at n = 2
and 4) and replay the reference's ``send_window_depths``; moe's
``probe=`` records the reference's marks. The log decoder
(``kernels/window.py`` and each kernel's ``check_log``) accepts a log
that keeps the contract and refuses one that breaks it: a depth over
the cap, an undrained window, rounds out of order, a missing round, a
receive tick short of ``completion_ticks``, an overflowed log. Every
wrapper refuses a ``contexts`` outside ``CONTEXTS`` before any launch;
the plain outputs do not depend on ``contexts``; and a directive's
``contexts`` reaches the kernel wrapper from every workload that builds
one (the wrapper's keyword arguments recorded). The logs a card writes
are held by ``tests/test_torch_gpu_window.py``.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import schedule as jsched
from repro.core import trace as jt
from repro_torch.configs import get_arch, reduced
from repro_torch.core import design_space as tds
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import Rules
from repro_torch.kernels import gemm_allgather as ga
from repro_torch.kernels import kv_shuttle as kv
from repro_torch.kernels import moe_dispatch as moe
from repro_torch.kernels import ring_attention as ra
from repro_torch.kernels import window
from repro_torch.models import init_params
from repro_torch.models.model import with_kernel_weights
from repro_torch.models.moe import moe_apply
from repro_torch.workloads.gemm_allgather import GemmAllGather
from repro_torch.workloads.kv_transfer import KVTransfer
from repro_torch.workloads.moe_dispatch import MoEDispatch
from repro_torch.workloads.ring_attention import RingAttention
from repro_torch.workloads.serving import ServingStep

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import chip_smoke  # noqa: E402

MARKS = ["dispatch_issued", "shared_ffn", "dispatch_drained"]


def _ga_inputs(n, M_l=256, K=16, N=8, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, M_l, K))
                             .astype(np.float32)),
            torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)))


def _moe_inputs(n=4, T=96, d=16, f=16, fs=16, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((n, T, d), (n, d, 2 * f), (n, f, d), (d, 2 * fs), (fs, d))]
    return [torch.from_numpy(a) for a in arrs]


# ------------------------------------------------ the recorder on the cpu


@pytest.mark.parametrize("counter", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("contexts", [1, 2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_allgather_probe_passes_the_reference_check(n, contexts, fused,
                                                         counter):
    """The port's recorded round program passes the reference's
    ``ScheduleProbe.check`` against the reference's schedule, and the
    output is the plain version's."""
    a, b = _ga_inputs(n)
    probe = jt.ScheduleProbe()
    out = ga.gemm_allgather(a, b, tile_m=32, fused=fused, counter=counter,
                            contexts=contexts, probe=probe)
    sched = jsched.make_broadcast_schedule(n, a.shape[1], 32, fused)
    got = probe.check(sched, contexts, counter)
    assert got["rounds"] == len(sched.rounds)
    assert got["max_depth"] == min(contexts, len(sched.rounds))
    assert torch.equal(out, ga.gemm_allgather_plain(a, b))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("contexts", [1, 2, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_gemm_allgather_depth_profile_is_the_references(n, contexts, fused):
    """The in-flight depth after each issue, replayed from the port's
    events, is the reference's ``send_window_depths``."""
    a, b = _ga_inputs(n, M_l=384)
    probe = jt.ScheduleProbe()
    ga.gemm_allgather(a, b, tile_m=64, fused=fused, contexts=contexts,
                      probe=probe)
    depth, depths = 0, []
    for ev in probe.events:
        depth += {"issue": 1, "wait_send": -1}.get(ev[0], 0)
        if ev[0] == "issue":
            depths.append(depth)
    sched = jsched.make_broadcast_schedule(n, 384, 64, fused)
    assert depths == list(jsched.send_window_depths(sched.rounds, contexts))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("contexts", [1, 2, 4])
def test_moe_probe_records_the_reference_marks(contexts, shared):
    """``moe_dispatch_combine(..., probe=)`` records the reference's marks:
    the shared FFN between the last dispatch issue and the drain."""
    x, w1, w2, s1, s2 = _moe_inputs()
    counts = [50, 30, 10, 6]
    probe = jt.ScheduleProbe()
    out = moe.moe_dispatch_combine(
        x, w1, w2, counts=counts, block_tokens=16, tile_fused=True,
        shared=(x, s1, s2) if shared else None, contexts=contexts,
        probe=probe)
    want = MARKS if shared else [MARKS[0], MARKS[2]]
    assert probe.marks == want
    ref = moe.moe_dispatch_combine_ref(x, w1, w2, counts=counts,
                                       block_tokens=16,
                                       shared=(x, s1, s2) if shared else None)
    for g, r in zip(out if shared else [out], ref if shared else [ref]):
        assert torch.equal(g, r)


# ------------------------------------------------------------ the decoder


def _synth_log(rounds_per_cta, contexts, recv_per_cta, cap=None):
    """A log as the card writes it: each CTA pushes its rounds through a
    ``contexts``-deep window (retire the oldest past the cap), drains,
    then waits its receives."""
    rows = []
    for rounds, recv in zip(rounds_per_cta, recv_per_cta):
        evs, depth = [], 0
        for edge, tile in rounds:
            if depth == contexts:
                evs.append([window.EV_RETIRE, 0, 0, 0])
                depth -= 1
            evs.append([window.EV_PUSH, edge, tile, 0])
            depth += 1
        evs += [[window.EV_RETIRE, 0, 0, 0]] * depth
        evs.append([window.EV_DRAIN, 0, 0, 0])
        evs += [[window.EV_RECV, e, c, 0] for e, c in recv]
        rows.append(evs)
    cap = cap or max(len(r) for r in rows)
    events = torch.zeros((len(rows), cap, 4), dtype=torch.int32)
    for i, r in enumerate(rows):
        if r:
            events[i, :len(r)] = torch.tensor(r[:cap], dtype=torch.int32)
    counts = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    return events, counts


GA_SHAPE = dict(n=2, M_l=256, N=256, tile_m=128, fused=True, counter=True)


def _ga_log(contexts=2, per_rank=2, drop_recv=0):
    n, M_l, N = GA_SHAPE["n"], GA_SHAPE["M_l"], GA_SHAPE["N"]
    rounds, recv = [], []
    for cta in range(n * per_rank):
        pid = cta // n
        rounds.append(ga.card_rounds(n, M_l, N, per_rank, pid, True))
        ticks = [(1, c) for c in range(M_l // 128)][pid::per_rank]
        recv.append(ticks[drop_recv if cta == 0 else 0:])
    return _synth_log(rounds, contexts, recv)


def _check_ga(events, counts, contexts=2):
    return ga.check_log(window.decode(events, counts), contexts=contexts,
                        **GA_SHAPE)


def _drop(events, counts, cta, kind, which=0):
    """The log without the ``which``-th event of ``kind`` of ``cta``."""
    n = int(counts[cta])
    rows = events[cta, :n].tolist()
    hits = [i for i, r in enumerate(rows) if r[0] == kind]
    del rows[hits[which]]
    events = events.clone()
    events[cta, :n - 1] = torch.tensor(rows, dtype=torch.int32)
    counts = counts.clone()
    counts[cta] = n - 1
    return events, counts


def test_decoder_accepts_a_log_that_keeps_the_contract():
    got = _check_ga(*_ga_log(contexts=2))
    assert got["max_depth"] == 2 and got["ctas"] == 4


def _depth_over_the_cap():
    """contexts 1: the retire before CTA 0's second push left out."""
    return _drop(*_ga_log(contexts=1), 0, window.EV_RETIRE) + (1,)


def _undrained():
    events, counts = _ga_log(contexts=2)
    return _drop(events, counts, 0, window.EV_RETIRE, -1) + (2,)


def _out_of_order():
    events, counts = _ga_log(contexts=2)
    events = events.clone()
    pushes = [i for i in range(int(counts[0]))
              if int(events[0, i, 0]) == window.EV_PUSH]
    a, b = pushes[0], pushes[-1]
    events[0, [a, b], 1:3] = events[0, [b, a], 1:3]
    return events, counts, 2


def _tick_short():
    events, counts = _ga_log(contexts=2)
    return _drop(events, counts, 0, window.EV_RECV) + (2,)


def _overflowed():
    events, counts = _ga_log(contexts=2)
    counts = counts.clone()
    counts[1] = events.shape[1] + 1
    return events, counts, 2


@pytest.mark.parametrize("defect,match", [
    (_depth_over_the_cap, "exceeded"),
    (_undrained, "not drained"),
    (_out_of_order, "order"),
    (_tick_short, "completion_ticks"),
    (_overflowed, "overflowed"),
])
def test_decoder_refuses_a_log_that_breaks_the_contract(defect, match):
    with pytest.raises(window.WindowLogError, match=match):
        _check_ga(*defect())


def test_decoder_refuses_a_missing_round():
    """A rank whose CTAs together leave a round out fails, though each
    CTA's own window keeps the contract."""
    events, counts = _synth_log([[(0, 0), (0, 1)], [(0, 3)]], 2, [[], []])
    ctas = window.decode(events, counts)
    for evs in ctas:
        window.check_cta(evs, 2)
    with pytest.raises(window.WindowLogError, match="missing"):
        window.check_rank(ctas, [(0, t) for t in range(4)])


def test_ring_and_kv_checks_hold_their_schedules():
    """The ring's and the shuttle's ``check_log`` accept a log of their
    schedule's rounds and refuse one CTA's round left out."""
    n, Sl, kc, c = 2, 128, 32, 2
    rounds = ra.schedule_for(n, Sl, fused=True, kv_chunk=kc).rounds
    per_cta = [rounds] * 4
    recv = [[(s, ch) for s in range(1, n) for ch in range(Sl // kc)]] * 4
    events, counts = _synth_log(per_cta, c, recv)
    rows = [list(r[:int(k)]) for r, k in zip(events.tolist(), counts)]
    for r in rows:             # one drain a step, as the kernel logs
        r.insert(0, [window.EV_DRAIN, 0, 0, 0])
    events = torch.tensor([r + [[0, 0, 0, 0]] * (events.shape[1] + 1 - len(r))
                           for r in rows], dtype=torch.int32)
    counts = counts + 1
    decoded = window.decode(events, counts)
    got = ra.check_log(decoded, [0, 2, 4], n=n, Sl=Sl, contexts=c,
                       fused=True, kv_chunk=kc)
    assert got["max_depth"] == c
    short = _drop(events, counts, 3, window.EV_PUSH, -1)
    with pytest.raises(window.WindowLogError):
        ra.check_log(window.decode(*short), [0, 2, 4], n=n, Sl=Sl,
                     contexts=c, fused=True, kv_chunk=kc)
    # the shuttle on its mma_sync core: 4 units (2 m-tiles of 64 rows, K
    # and V) over 2 prefill CTAs, the decode CTA's ticks, one a K / V
    # chunk pair
    halves = kv._units(128, 128, 32, True, False, 1, "mma_sync")
    order = [(h, u) for u, h in enumerate(halves)]
    events, counts = _synth_log([order[0::2], order[1::2], []], c,
                                [[], [], [(0, ch) for ch in range(4)]])
    meta = dict(rows=128, width=128, pure=False, unit_rows=1, grid=3,
                contexts=c, fused=True, counter=True, kv_chunk=32,
                core="mma_sync")
    assert kv.check_log(window.decode(events, counts), **meta)["rounds"] == 4
    with pytest.raises(window.WindowLogError, match="completion_ticks"):
        kv.check_log(window.decode(*_drop(events, counts, 2,
                                          window.EV_RECV)), **meta)


# ------------------------------------------------------ the wrappers' knob


def _calls(contexts):
    a, b = _ga_inputs(2, M_l=64)
    x, w1, w2, s1, s2 = _moe_inputs()
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 2, 64, 8)).astype(np.float32))
    kx = torch.zeros((2, 64, 16))
    kx[0] = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 16)).astype(np.float32))
    wk = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, 8)).astype(np.float32))
    cache = torch.zeros((2, 64, 8), dtype=torch.bfloat16)
    cache[0] = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 8)).astype(np.float32)).bfloat16()
    return {
        "gemm_allgather": lambda: ga.gemm_allgather(a, b, contexts=contexts),
        "ring_attention": lambda: ra.ring_attention(
            q, q, q, fused=True, counter=True, kv_chunk=16,
            contexts=contexts),
        "kv_shuttle": lambda: kv.kv_shuttle(kx, wk, wk, contexts=contexts),
        "kv_cache_shuttle": lambda: kv.kv_cache_shuttle(cache,
                                                        contexts=contexts),
        "moe_dispatch_combine": lambda: moe.moe_dispatch_combine(
            x, w1, w2, counts=[50, 30, 10, 6], block_tokens=16,
            tile_fused=True, shared=(x, s1, s2), contexts=contexts),
    }


@pytest.mark.parametrize("contexts", [0, 3])
@pytest.mark.parametrize("wrapper", list(_calls(1)))
def test_every_wrapper_refuses_a_contexts_outside_contexts(wrapper, contexts):
    with pytest.raises(ValueError, match="contexts must be one of"):
        _calls(contexts)[wrapper]()


@pytest.mark.parametrize("wrapper", list(_calls(1)))
def test_plain_outputs_are_bit_equal_across_contexts(wrapper):
    outs = [_calls(c)[wrapper]() for c in tds.CONTEXTS]
    flat = [o if isinstance(o, tuple) else (o,) for o in outs]
    for other in flat[1:]:
        assert all(torch.equal(p, q) for p, q in zip(flat[0], other))


def _recorder(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def record(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, record)
    return seen


WORKLOADS = {
    "MoEDispatch": (lambda: MoEDispatch(n_dev=4, tokens_per_rank=96, d=16,
                                        f=16), moe, "moe_dispatch_combine",
                    dict(T=96)),
    "ServingStep": (lambda: ServingStep(n_dev=4, tokens_per_rank=96, d=16,
                                        f=16, f_shared=16), moe,
                    "moe_dispatch_combine", dict(T=96)),
    "KVTransfer": (lambda: KVTransfer(T=64, d=16, dk=8), kv, "kv_shuttle",
                   dict(T=64)),
    "GemmAllGather": (lambda: GemmAllGather(n_dev=4, M=256, K=16, N=8), ga,
                      "gemm_allgather", dict(M_l=64)),
    "RingAttention": (lambda: RingAttention(n_dev=4, BH=2, seq=256, hd=8),
                      ra, "ring_attention", dict(sl=64)),
}


@pytest.mark.parametrize("contexts", [1, 2, 4])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_a_directives_contexts_reaches_the_kernel_wrapper(monkeypatch, name,
                                                          contexts):
    make, module, fn, size = WORKLOADS[name]
    seen = _recorder(monkeypatch, module, fn)
    w = make()
    d = dataclasses.replace(tds.EXPERT_SYSTEMS["FLUX"], contexts=contexts)
    mesh = VirtualMesh(w.n_dev, device="cpu")
    w.build(d, mesh)(*w.example_inputs(0, mesh, **size))
    assert [k["contexts"] for k in seen] == [contexts]


def test_moe_apply_passes_contexts_2_and_its_probe_to_the_kernel(monkeypatch):
    """The MoE layer's pallas body launches at the reference's contexts=2
    and hands ``probe`` through: the kernel's marks land on it."""
    seen = _recorder(monkeypatch, moe, "moe_dispatch_combine")
    cfg = reduced(get_arch("llama4-maverick-400b-a17b"), num_experts=4,
                  experts_per_token=1, pad_to=2, dtype="float32")
    params = with_kernel_weights(
        init_params(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg)
    block = next(b for b in params["blocks"].values() if "moe" in b)
    block = torch.utils._pytree.tree_map(lambda t: t[0], block)  # layer 0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 3, cfg.d_model)).astype(np.float32))
    probe = jt.ScheduleProbe()
    moe_apply(block["moe"], x, cfg, Rules(VirtualMesh(4, device="cpu",
                                                      axis="data"), "decode"),
              overlap=True, backend="pallas", probe=probe)
    assert [k["contexts"] for k in seen] == [2]
    assert seen[0]["probe"] is probe
    assert probe.marks == MARKS


# ------------------------------------------------------------- chip_smoke


def test_chip_smoke_holds_the_directives_contexts():
    """A counted path fails where a directive's ``contexts`` never reached
    the kernel, and passes where it did."""

    class Kern:
        def __init__(self, seen):
            self.CONTEXTS_LAUNCHED = {c: 1 for c in seen}

        def launches(self):
            return sum(self.CONTEXTS_LAUNCHED.values())

    asked = chip_smoke._asked(chip_smoke.ring_directives())
    assert asked == {1, 2}
    assert chip_smoke._contexts_seen("ring_main", [Kern([1, 2])], asked) \
        == [1, 2]
    with pytest.raises(SystemExit, match="did not all reach"):
        chip_smoke._contexts_seen("ring_main", [Kern([2])], asked)
