"""The port's fault tolerance against the JAX package, and elastic serving,
on the CPU.

``repro_torch.train.fault_tolerance`` copies
``repro/train/fault_tolerance.py``: on the same timing sequences (numpy,
from a seed) the two ``StragglerWatchdog``s give the same incidents,
``recent_incidents`` and ``should_replace`` after every record, and the
two ``ElasticController``s the same drops, live ranks, degraded schedules
and workloads, and metrics snapshot. ``Engine.degrade`` is held on a
``VirtualMesh(4, "cpu")`` data mesh at the reduced llama4 MoE config in
float32: a degrade to 2 ranks mid-``serve`` completes every request with
the counters right and, at a capacity where no token drops, the tokens of
the undegraded run; under ``moe_backend="pallas"`` a degrade onto a width
the kernel cannot take raises.
"""
import dataclasses
import os
import signal
import sys

import numpy as np
import pytest
import torch

from repro.core import schedule as jsched
from repro.train import fault_tolerance as jft
from repro.workloads.gemm_allgather import GemmAllGather as JGA
from repro.workloads.moe_dispatch import MoEDispatch as JMoE
from repro.workloads.ring_attention import RingAttention as JRing
from repro_torch.configs import get_arch, reduced
from repro_torch.core import schedule as tsched
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import Rules
from repro_torch.models import StepOptions, init_params
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.train import fault_tolerance as tft
from repro_torch.workloads.gemm_allgather import GemmAllGather as TGA
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.ring_attention import RingAttention as TRing

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

WATCH = [dict(), dict(window=16, threshold=2.0, min_samples=4),
         dict(window=8, threshold=1.5, min_samples=2, incident_window=8,
              replace_after=3)]


def timings(seed, n=60):
    """A step-time sequence with jitter, isolated blips, a persistent
    straggling stretch and per-round tick counts."""
    rng = np.random.default_rng(seed)
    t = 1.0 + 0.2 * rng.random(n)
    t[rng.choice(n, 4, replace=False)] *= 6.0
    t[n // 2:n // 2 + 6] *= 4.0
    ticks = rng.integers(1, 5, n)
    return t.tolist(), ticks.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", range(len(WATCH)))
def test_watchdog_equal_reference(kw, seed):
    j, t = jft.StragglerWatchdog(**WATCH[kw]), tft.StragglerWatchdog(
        **WATCH[kw])
    times, ticks = timings(seed)
    for i, (s, k) in enumerate(zip(times, ticks)):
        k = k if seed else 1
        assert t.record(s, ticks=k) == j.record(s, ticks=k), i
        assert (t.incidents, t.recent_incidents, t.should_replace) \
            == (j.incidents, j.recent_incidents, j.should_replace), i
        assert t.times == j.times
        if i == 40:
            t.reset()
            j.reset()
            assert (t.incidents, t.times) == (0, [])


def test_preemption_guard_catches_sigterm():
    with tft.PreemptionGuard() as g:
        assert not g.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested
    assert signal.getsignal(signal.SIGTERM) != g._handler


def schedules(mod):
    return [mod.make_schedule((100, 80, 60, 40)),
            mod.make_broadcast_schedule(4, 512, 128),
            mod.make_ring_schedule(4, 512, 64)]


@pytest.mark.parametrize("seed", [0, 3])
def test_elastic_controller_equal_reference(seed):
    """Per-rank watchdogs fed the same rounds drop the same rank, degrade
    the same schedules and workloads onto the survivors, and export the
    same metrics."""
    rng = np.random.default_rng(seed)
    kw = dict(n_ranks=4, min_samples=4, replace_after=3, threshold=1.8)
    j, t = jft.ElasticController(**kw), tft.ElasticController(**kw)
    slow = int(rng.integers(0, 4))
    for step in range(24):
        ticks = int(rng.integers(1, 3))    # a bigger round takes longer
        times = {r: float(ticks * (1.0 + 0.1 * rng.random()))
                 for r in range(4)}
        if step >= 10:
            times[slow] *= 5.0
        assert t.observe_round(times, ticks) == j.observe_round(times, ticks)
        assert t.live_ranks == j.live_ranks
    assert slow not in t.live_ranks and len(t.live_ranks) == 3
    for ts, js in zip(schedules(tsched), schedules(jsched)):
        td, jd = t.degrade(ts), j.degrade(js)
        assert type(td).__name__ == type(jd).__name__
        assert list(td.rounds) == list(jd.rounds)
    for tw, jw in ((TMoE(), JMoE()), (TGA(), JGA()), (TRing(), JRing())):
        td, jd = t.degrade(tw), j.degrade(jw)
        assert td.n_dev == jd.n_dev == 3
        assert {k: v for k, v in vars(td).items()} == {
            k: v for k, v in vars(jd).items()}
    assert t.metrics.snapshot() == j.metrics.snapshot()
    t.drop(t.live_ranks[0])
    t.drop(t.live_ranks[0])
    with pytest.raises(RuntimeError, match="last live rank"):
        t.drop(t.live_ranks[0])


# ------------------------------------------------------ elastic serving


S, NEW = 12, 5


def config(cf):
    return reduced(get_arch("llama4-maverick-400b-a17b"), num_experts=4,
                   experts_per_token=1, pad_to=2, capacity_factor=cf,
                   dtype="float32")


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), config(16.0),
                       device="cpu")


def engine(cfg, params, watchdog=None, backend="pallas"):
    return Engine(cfg, params, ServeConfig(
        max_seq=S + NEW + 1, opts=StepOptions(moe_backend=backend,
                                              moe_overlap=True)),
        rules=Rules(VirtualMesh(4, device="cpu", axis="data"), "decode"),
        watchdog=watchdog)


def serve(eng, prompts, on_step=None):
    sched = Scheduler(token_budget=4 * S, max_batch=4, metrics=eng.metrics)
    for rid, p in enumerate(prompts):
        sched.submit(Request(rid, p, max_new_tokens=NEW))
    return eng.serve(sched, on_step=on_step)


@pytest.mark.parametrize("cf", [1.25, 16.0])
def test_engine_degrades_mid_serve_and_keeps_serving(params, cf):
    """Rank 3 is dropped at step 1: the pallas degrade onto 2 ranks
    raises, the hook switches to xla in the open and degrades; every
    request completes, the counters are right, the watchdog saw every
    decode step and, where no token drops (capacity 16), the tokens are
    the undegraded run's."""
    cfg = config(cf)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (4, S)).tolist()
    ctl = tft.ElasticController(4)
    dog = tft.StragglerWatchdog(min_samples=2, threshold=0.0)
    eng = engine(cfg, params, watchdog=dog)
    seen = {}

    def on_step(step, e):
        if step != 1:
            return
        ctl.drop(3)
        live = len(ctl.live_ranks) // 2 * 2
        with pytest.raises(ValueError, match="num_experts_padded=4 for a "
                           "new width of 2"):
            e.degrade(live)
        seen["rules"] = e.rules
        e.scfg.opts = dataclasses.replace(e.scfg.opts, moe_backend="xla")
        seen["new"] = e.degrade(ctl.live_ranks[:live])

    done = serve(eng, prompts, on_step)
    assert sorted(done) == [0, 1, 2, 3]
    assert all(len(done[r]) == NEW for r in done)
    c = eng.metrics.snapshot()["counters"]
    assert c["serve.degrades"] == 1 and eng._gen == 1
    assert c["serve.tokens_generated"] == 4 * (NEW - 1)
    assert c["serve.decode_steps"] == NEW - 1
    assert c["serve.watchdog_incidents"] == dog.incidents
    assert len(dog.times) == NEW - 1 and dog.incidents == NEW - 2
    assert seen["rules"].dp_size() == 4            # the refusal kept them
    assert seen["new"] is eng.rules and eng.rules.dp_size() == 2
    assert eng.rules.mesh.axis == "data" and eng.rules.kind == "decode"
    assert ctl.live_ranks == (0, 1, 2)
    if cf == 16.0:
        want = serve(engine(cfg, params), prompts)
        assert all(torch.equal(done[r], want[r]) for r in range(4))


def test_degrade_under_pallas_raises_where_the_kernel_cannot_run(params):
    cfg = config(16.0)
    eng = engine(cfg, params)
    for width in (2, 3, [0, 1], 1):
        with pytest.raises(ValueError, match="num_experts_padded"):
            eng.degrade(width)
    assert eng.rules.dp_size() == 4 and eng._gen == 0
    assert eng.degrade(4).dp_size() == 4           # the kernel's width
    xla = engine(cfg, params, backend="xla")
    assert xla.degrade(2).dp_size() == 2
    assert xla.degrade(1) is None and xla.rules is None   # the local path
    with pytest.raises(ValueError, match="one at least"):
        xla.degrade(0)
    assert xla.metrics.snapshot()["counters"]["serve.degrades"] == 2


def test_chip_smoke_serve_degrade_on_the_cpu():
    c = chip_smoke.phase_serve_degrade("cpu", chip_smoke.moe_engine_config(
        small=True), chip_smoke.moe_serve_shape(small=True))
    assert c["serve.degrades"] == 1 and c["sched.finished"] == 4
