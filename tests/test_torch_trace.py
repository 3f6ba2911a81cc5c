"""The port's modeled timelines and schedule probe against the JAX package,
on the CPU.

``repro_torch.core.trace`` copies ``repro/core/trace.py``. Held here:
``TraceWriter`` emits the reference's JSON for the same calls;
``validate_trace`` gives the same verdicts (event count, or the same
``ValueError``); ``schedule_timeline(...).to_dict()`` equals the
reference's event for event (strings and integers exactly, floats within
1e-9 relative) for every workload at FLUX and ``CONSERVATIVE``, healthy,
degraded and under fault plans, both sides on the ``V5E`` context; the
critical path equals ``analytic_cost`` or ``fault_cost`` within 1e-6 s on
the port's ``H100`` context too; and ``ScheduleProbe.check`` accepts and
refuses the same synthetic event streams.
"""
import json

import pytest

from repro.core import design_space as jds
from repro.core import faults as jf
from repro.core import schedule as jsched
from repro.core import trace as jt
from repro.core.hardware import V5E as JV5E
from repro.core.hardware import HardwareContext as JHW
from repro.workloads.gemm_allgather import GemmAllGather as JGA
from repro.workloads.kv_transfer import KVTransfer as JKV
from repro.workloads.moe_dispatch import MoEDispatch as JMoE
from repro.workloads.ring_attention import RingAttention as JRing
from repro.workloads.serving import ServingStep as JServing
from repro_torch.core import design_space as tds
from repro_torch.core import faults as tf
from repro_torch.core import schedule as tsched
from repro_torch.core import trace as tt
from repro_torch.core.hardware import H100, V5E, HardwareContext
from repro_torch.workloads.gemm_allgather import GemmAllGather as TGA
from repro_torch.workloads.kv_transfer import KVTransfer as TKV
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.ring_attention import RingAttention as TRing
from repro_torch.workloads.serving import ServingStep as TServing

WORKLOADS = {"moe_dispatch": (JMoE, TMoE), "serving_step": (JServing,
                                                            TServing),
             "gemm_allgather": (JGA, TGA), "ring_attention": (JRing, TRing),
             "kv_transfer": (JKV, TKV)}
POINTS = {"flux": jds.EXPERT_SYSTEMS["FLUX"], "conservative":
          jds.CONSERVATIVE, "deepep": jds.EXPERT_SYSTEMS["DeepEP (NVL)"]}


def ctx(cls, chip, n):
    return cls(chip=chip, mesh_shape=(n,), mesh_axes=("x",),
               chips_per_pod=n, n_chips=n, has_dcn=False)


def plan(mod, n):
    faults = [mod.FaultSpec(mod.STRAGGLER, rank=0, rounds=8, delay_s=50e-6)]
    if n > 2:
        faults.append(mod.FaultSpec(mod.DROPPED_PEER, rank=1))
    return mod.FaultPlan("trace-plan", tuple(faults))


def same_value(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            same_value(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same_value(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), path
        assert got == want or abs(got - want) <= 1e-9 * abs(want), (
            path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def writer_calls(w):
    w.meta_process(0, "rank 0")
    w.meta_thread(0, 0, "critical path")
    w.span("gemm", 0.0, 120.5, pid=0, tid=0, args={"kind": "compute"})
    w.span("wire", 120.5, 3, pid=1, tid=2, cat="dma")
    w.counter("send window", 10.0, {"in_flight": 2, "cap": 4}, pid=0)
    w.instant("dma issue (1,0)", 12.0, pid=0, tid=1, args={"round": 0})
    w.instant("tick", 13, pid=2, tid=2)
    return w


def test_trace_writer_json_equal_reference(tmp_path):
    got, want = writer_calls(tt.TraceWriter()), writer_calls(jt.TraceWriter())
    assert got.to_json() == want.to_json()
    assert got.to_json(indent=2) == want.to_json(indent=2)
    got.write(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == want.to_dict()
    assert tt.validate_trace(got.to_dict()) == 7


TRACES = [
    {"traceEvents": []},
    {"events": []},
    [],
    {"traceEvents": {}},
    {"traceEvents": [{"ph": "Z", "name": "x"}]},
    {"traceEvents": [{"ph": "X", "name": "x", "ts": 0.0, "pid": 0,
                      "tid": 0}]},
    {"traceEvents": [{"ph": "X", "name": "x", "ts": 0.0, "dur": -1.0,
                      "pid": 0, "tid": 0}]},
    {"traceEvents": [{"ph": "i", "name": "x", "ts": -1.0, "pid": 0,
                      "tid": 0, "s": "t"}]},
    {"traceEvents": [{"ph": "C", "name": "c", "ts": 1.0, "pid": 0}]},
    {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0,
                      "args": {"name": "r"}},
                     {"ph": "C", "name": "c", "ts": 1.0, "pid": 0,
                      "args": {"v": 1.0}}]},
]


@pytest.mark.parametrize("i", range(len(TRACES)))
def test_validate_trace_verdicts_equal_reference(i):
    obj = TRACES[i]
    try:
        want = jt.validate_trace(obj)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tt.validate_trace(obj)
        assert str(te.value) == str(e)
    else:
        assert tt.validate_trace(obj) == want


def timelines(name, point):
    """(port, reference) timelines of every kind for one workload."""
    jcls, tcls = WORKLOADS[name]
    jw, tw = jcls(), tcls()
    n = jw.n_dev
    jhw, thw = ctx(JHW, JV5E, n), ctx(HardwareContext, V5E, n)
    jd = POINTS[point]
    td = tds.directive_from_dict(jd.as_dict())
    live = tuple(range(n))[:-1]
    out = []
    for kw_j, kw_t in (({}, {}),
                       ({"live_ranks": live}, {"live_ranks": live}),
                       ({"plan": plan(jf, n)}, {"plan": plan(tf, n)}),
                       ({"plan": jf.FaultPlan("healthy")},
                        {"plan": tf.FaultPlan("healthy")})):
        out.append((tt.schedule_timeline(tw, td, thw, **kw_t),
                    jt.schedule_timeline(jw, jd, jhw, **kw_j)))
    return out


@pytest.mark.parametrize("point", list(POINTS))
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_schedule_timeline_equal_reference_event_for_event(name, point):
    for got, want in timelines(name, point):
        same_value(got.to_dict(), want.to_dict(), "trace")
        assert got.degraded == want.degraded
        assert got.live_ranks == want.live_ranks
        assert got.workload_name == want.workload_name
        same_value(got.meta, want.meta, "meta")
        same_value(got.critical_path_s, want.critical_path_s, "critical")


@pytest.mark.parametrize("point", list(POINTS))
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_critical_path_equals_the_cost_on_the_h100(name, point):
    """The invariant on the port's own context: the rendered timeline
    audits exactly the scalar the cascade scores."""
    w = WORKLOADS[name][1]()
    hw = ctx(HardwareContext, H100, w.n_dev)
    d = tds.directive_from_dict(POINTS[point].as_dict())
    live = tuple(range(w.n_dev))[:-1]
    p = plan(tf, w.n_dev)
    for kw, want in (({}, w.analytic_cost(d, hw)),
                     ({"live_ranks": live},
                      w.degrade(live).analytic_cost(d, hw)),
                     ({"plan": p}, tf.fault_cost(w, d, hw, p))):
        tl = tt.schedule_timeline(w, d, hw, **kw)
        assert abs(tl.critical_path_s - want) <= 1e-6
        assert tt.validate_trace(tl.to_dict()) > 0
    with pytest.raises(ValueError, match="not both"):
        tt.schedule_timeline(w, d, hw, plan=p, live_ranks=live)


def schedules(mod):
    return [mod.make_schedule((10, 7, 3, 0), 4, True),
            mod.make_schedule((5, 5, 5), 2, False),
            mod.make_ring_schedule(4, 256, 64, fused=True),
            mod.make_ring_schedule(3, 96, 96, fused=False),
            mod.make_broadcast_schedule(4, 256, 64, True),
            mod.make_broadcast_schedule(3, 128, 128, False)]


def streams(sched, contexts, counter):
    """Synthetic probe streams for one schedule: the faithful replay
    (issue, retire the oldest past the cap, drain, then the schedule's
    receive waits), and five mutations of it."""
    cap = max(1, int(contexts))
    rounds = list(sched.rounds)
    ticks = sched.completion_ticks(counter) \
        if hasattr(sched, "completion_ticks") else 0

    def replay(order, cap, drain=True, waits=ticks, mark=False):
        ev, depth = [], 0
        for i, (e, t) in enumerate(order):
            if depth >= cap:
                ev.append(("wait_send",))
                depth -= 1
            ev.append(("issue", e, t))
            depth += 1
            if mark and i == 0:
                ev.append(("mark", "shared_ffn"))
        if drain:
            ev += [("wait_send",)] * depth
        return ev + [("wait_recv", i % 2) for i in range(waits)]

    out = {"faithful": replay(rounds, cap),
           "marked": replay(rounds, cap, mark=True),
           "undrained": replay(rounds, cap, drain=False),
           "extra_recv": replay(rounds, cap, waits=ticks + 1),
           "window_too_deep": replay(rounds, cap + 1)}
    if len(rounds) > 1:
        out["reordered"] = replay(rounds[1:] + rounds[:1], cap)
    return out


def feed(probe, events):
    probe.reset()
    for ev in events:
        if ev[0] == "issue":
            probe.issue(ev[1], ev[2])
        elif ev[0] == "wait_send":
            probe.wait_send()
        elif ev[0] == "wait_recv":
            probe.wait_recv(ev[1])
        else:
            probe.mark(ev[1])
    return probe


@pytest.mark.parametrize("counter", [True, False])
@pytest.mark.parametrize("contexts", [1, 2, 4])
def test_schedule_probe_accepts_and_refuses_like_reference(contexts,
                                                           counter):
    verdicts = set()
    for ts, js in zip(schedules(tsched), schedules(jsched)):
        for kind, events in streams(js, contexts, counter).items():
            jp, tp = feed(jt.ScheduleProbe(), events), \
                feed(tt.ScheduleProbe(), events)
            assert tp.issued == jp.issued and tp.marks == jp.marks
            assert tp.recv_waits == jp.recv_waits
            try:
                want = jp.check(js, contexts, counter)
            except AssertionError as e:
                with pytest.raises(AssertionError) as te:
                    tp.check(ts, contexts, counter)
                assert str(te.value) == str(e)
                verdicts.add((kind, False))
            else:
                assert tp.check(ts, contexts, counter) == want
                verdicts.add((kind, True))
    assert ("faithful", True) in verdicts and ("reordered", False) in verdicts
    assert ("undrained", False) in verdicts
