"""Modeled-timeline tracing — the l3 cost model rendered as a Perfetto
trace (the observability layer of the search's "auditable cost").

Port copy of ``repro/core/trace.py``. Two halves:

* :class:`TraceWriter` — a minimal Chrome-trace-event/Perfetto JSON
  emitter (complete spans, counter tracks, instant events, process/thread
  metadata). ``write()`` produces a file that loads directly in
  https://ui.perfetto.dev (timestamps in microseconds, the trace-event
  convention).
* :func:`schedule_timeline` — renders one directive's
  ``Workload.cost_breakdown`` as a per-rank modeled timeline laid over the
  ``CollectiveSchedule`` round order: the critical-path segments become
  spans, DMA-issue rounds (``issued_rounds()``) become instants inside the
  overlap span, the send-window occupancy (``send_window_depths()``)
  becomes a counter track, COUNTER arrival ticks land on the receive
  thread, window-recycle stalls render as explicit ``stall`` slices, and
  degraded-mode membership (``degrade(live_ranks)``) / fault plans splice
  recovery + remesh + straggler segments in.

**The invariant** (held by ``tests/test_torch_trace.py`` and
``chip_smoke.py``'s ``faults`` phase): the sum of the critical-path spans
of any rendered timeline equals ``analytic_cost()`` (or ``fault_cost()``
when a plan is given) within 1e-6 — both are derived from the same
:class:`~repro_torch.core.cost_model.CostBreakdown`, so the trace audits
exactly the scalar the cascade scores. The times are the cost model's on
the context's ``ChipSpec``: a model, not a measurement.

:class:`ScheduleProbe` is the observed-order probe: a kernel body records
its actual issue/wait sequence, and :meth:`ScheduleProbe.check` verifies
it against the lockstep schedule — round order, window cap, and arrival
count must match the ``CollectiveSchedule`` contract the cost model
charged. ``kernels/gemm_allgather.py`` and ``kernels/moe_dispatch.py``
record on it (``probe=``); the Hopper kernels' probe builds log each
CTA's window, which ``kernels/window.py`` decodes into its events.

Pure Python (no torch imports), mirroring core/schedule.py.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.core.cost_model import CostSegment
from repro_torch.core.faults import REMESH_OVERHEAD

__all__ = [
    "TraceWriter", "Timeline", "ScheduleProbe", "schedule_timeline",
    "validate_trace",
]

# thread ids of the per-rank track layout (one process per modeled rank)
TID_CRITICAL = 0      # the critical-path spans (sum == analytic_cost)
TID_DMA = 1           # DMA-issue round instants
TID_ARRIVALS = 2      # receive-side readiness ticks


class TraceWriter:
    """Chrome-trace-event ("JSON Array with metadata") emitter.

    Event fields follow the trace-event spec: ``ph`` is the phase ("X"
    complete span, "C" counter, "i" instant, "M" metadata), ``ts``/``dur``
    are microseconds (floats allowed), ``pid``/``tid`` name the track.
    """

    def __init__(self):
        self.events = []

    # ------------------------------------------------------------- metadata
    def meta_process(self, pid, name):
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": str(name)}})

    def meta_thread(self, pid, tid, name):
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": str(name)}})

    # --------------------------------------------------------------- events
    def span(self, name, ts_us, dur_us, *, pid=0, tid=0, cat="modeled",
             args=None):
        ev = {"ph": "X", "name": str(name), "cat": str(cat),
              "ts": float(ts_us), "dur": float(dur_us),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name, ts_us, values, *, pid=0, cat="modeled"):
        """One sample of a counter track; ``values`` maps series name ->
        number (Perfetto stacks multi-series counters)."""
        self.events.append({"ph": "C", "name": str(name), "cat": str(cat),
                            "ts": float(ts_us), "pid": pid, "tid": 0,
                            "args": {k: float(v) for k, v in values.items()}})

    def instant(self, name, ts_us, *, pid=0, tid=0, cat="modeled",
                args=None):
        ev = {"ph": "i", "name": str(name), "cat": str(cat),
              "ts": float(ts_us), "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # --------------------------------------------------------------- output
    def to_dict(self):
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def to_json(self, indent=None):
        return json.dumps(self.to_dict(), indent=indent)

    def write(self, path, indent=None):
        with open(path, "w") as f:
            f.write(self.to_json(indent=indent))


_REQUIRED = {"X": ("name", "ts", "dur", "pid", "tid"),
             "C": ("name", "ts", "pid", "args"),
             "i": ("name", "ts", "pid", "tid", "s"),
             "M": ("name", "pid", "args")}


def validate_trace(obj):
    """Structural validity of a trace dict (the schema the tests and
    ``chip_smoke.py`` assert): a ``traceEvents`` list whose events
    carry the per-phase required fields, non-negative timestamps and
    durations. Returns the event count; raises ``ValueError`` on the first
    malformed event."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a dict with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in _REQUIRED:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        for k in _REQUIRED[ph]:
            if k not in ev:
                raise ValueError(f"event {i} (ph={ph}): missing field {k!r}")
        if "ts" in ev and float(ev["ts"]) < 0:
            raise ValueError(f"event {i}: negative ts")
        if ph == "X" and float(ev["dur"]) < 0:
            raise ValueError(f"event {i}: negative dur")
    return len(events)


# --------------------------------------------------------------- timelines


@dataclass
class Timeline:
    """A rendered modeled timeline. ``critical_path_s`` is the sum of the
    critical-path spans (== ``analytic_cost`` / ``fault_cost`` by
    construction); ``breakdown`` is the CostBreakdown it was laid from."""
    writer: TraceWriter
    critical_path_s: float
    breakdown: object
    workload_name: str
    degraded: bool = False
    live_ranks: tuple = ()
    meta: dict = field(default_factory=dict)

    def to_dict(self):
        return self.writer.to_dict()

    def write(self, path, indent=None):
        self.writer.write(path, indent=indent)


_KIND_CAT = {"stall": "stall", "recovery": "recovery", "remesh": "recovery",
             "sync": "sync", "launch": "sync"}


def _anchor_segment(breakdown):
    """The span DMA rounds issue during: the first overlap segment, else
    the first wire segment, else the longest segment."""
    for kind in ("overlap", "wire"):
        for s in breakdown.segments:
            if s.kind == kind and s.dur_s > 0:
                return s
    return max(breakdown.segments, key=lambda s: s.dur_s)


def schedule_timeline(workload, directive, hw, *, live_ranks=None,
                      plan=None):
    """Render ``workload.cost_breakdown(directive, hw)`` as a per-rank
    Perfetto timeline (see module docstring for the track layout).

    ``live_ranks`` renders the degraded deployment (the workload reshapes
    via ``degrade`` exactly as ``fault_cost`` does). ``plan`` (a
    ``FaultPlan``) additionally splices the recovery / remesh / straggler
    segments so the critical path equals ``fault_cost(workload, directive,
    hw, plan)``. The healthy call renders ``analytic_cost``.
    """
    base = workload
    extra = []          # (name, dur_s, kind) appended after the breakdown
    if plan is not None:
        if live_ranks is not None:
            raise ValueError("pass live_ranks or plan, not both")
        live_ranks = plan.live_ranks(base.n_dev)
    degraded = False
    live = tuple(range(base.n_dev))
    if live_ranks is not None:
        from repro_torch.core.schedule import check_live
        live = check_live(live_ranks, base.n_dev)
        if len(live) < base.n_dev:
            degraded = True
            dead = base.n_dev - len(live)
            if plan is not None:
                # the fault_cost recovery terms, in fault_cost's order
                extra.append(("state_recovery",
                              dead * base.state_bytes_per_rank()
                              / hw.chip.ici_link_bw, "recovery"))
                extra.append(("remesh", REMESH_OVERHEAD, "remesh"))
            workload = base.degrade(live)
    if plan is not None:
        stall = plan.straggler_stall_s(directive.contexts)
        if stall or not extra:
            extra.append(("straggler_stall", stall, "stall"))

    bd = workload.cost_breakdown(directive, hw)
    w = TraceWriter()
    n = workload.n_dev
    sched = bd.schedule
    contexts = int(bd.knobs.get("contexts", max(1, directive.contexts)))

    critical = 0.0
    for rank in range(n):
        w.meta_process(rank, f"rank {rank} · {workload.name}")
        w.meta_thread(rank, TID_CRITICAL, "modeled critical path")
        if degraded:
            w.instant("degraded: live=" + ",".join(map(str, live)), 0.0,
                      pid=rank, tid=TID_CRITICAL, cat="fault",
                      args={"live_ranks": list(live)})
        cursor = 0.0
        rank_total = 0.0
        for seg in tuple(bd.segments) + tuple(
                CostSegment(nm, dur, kind) for nm, dur, kind in extra):
            dur_us = seg.dur_s * 1e6
            if dur_us > 0.0:
                args = {"kind": seg.kind}
                args.update({k: v for k, v in seg.meta.items()
                             if isinstance(v, (int, float, str, bool))})
                w.span(seg.name, cursor, dur_us, pid=rank, tid=TID_CRITICAL,
                       cat=_KIND_CAT.get(seg.kind, "modeled"), args=args)
            cursor += dur_us
            rank_total += seg.dur_s
        if rank == 0:
            critical = rank_total

        if sched is None:
            continue
        # ------------- schedule detail tracks (kernelized directives only)
        rounds = list(sched.rounds)
        depths = sched.send_window_depths(contexts)
        anchor = _anchor_segment(bd)
        a0 = 0.0
        for seg in bd.segments:
            if seg is anchor:
                break
            a0 += seg.dur_s * 1e6
        a_dur = anchor.dur_s * 1e6
        w.meta_thread(rank, TID_DMA, "dma issue rounds")
        w.meta_thread(rank, TID_ARRIVALS, "arrival ticks")
        step = a_dur / max(1, len(rounds))
        for i, (edge, tile) in enumerate(rounds):
            ts = a0 + i * step
            w.instant(f"dma issue ({edge},{tile})", ts, pid=rank,
                      tid=TID_DMA, cat="dma",
                      args={"round": i, "edge": edge, "tile": tile})
            w.counter("send window", ts, {"in_flight": depths[i]}, pid=rank)
        if rounds:
            w.counter("send window", a0 + a_dur, {"in_flight": 0}, pid=rank)
        ticks = _arrival_ticks(bd, sched)
        tstep = a_dur / max(1, ticks)
        for i in range(ticks):
            w.instant(f"arrival tick {i}", a0 + (i + 1) * tstep, pid=rank,
                      tid=TID_ARRIVALS, cat="dma", args={"tick": i})

    return Timeline(writer=w, critical_path_s=critical, breakdown=bd,
                    workload_name=workload.name, degraded=degraded,
                    live_ranks=live,
                    meta={"directive": directive.as_dict(),
                          "plan": getattr(plan, "name", None)})


def _arrival_ticks(bd, sched):
    """Receive-side readiness ticks of the rendered schedule: prefer the
    count the cost model actually charged (the ``tile_sync`` segment's
    meta), fall back to the schedule's own accounting."""
    for s in bd.segments:
        if "ticks" in s.meta:
            return int(s.meta["ticks"])
    if hasattr(sched, "completion_ticks"):
        return int(sched.completion_ticks(bool(bd.knobs.get("counter", True))))
    return 0


# ------------------------------------------------- observed-order probe


class ScheduleProbe:
    """Records the DMA issue/wait order a kernel body actually performs,
    then checks it against the lockstep schedule the cost model charged.

    Kernels accept ``probe=None`` and call :meth:`issue` /
    :meth:`wait_send` / :meth:`wait_recv` next to the corresponding DMA
    operations; :meth:`check` asserts the ``CollectiveSchedule`` contract:

    * the issued ``(edge, tile)`` order equals ``schedule.rounds``,
    * the replayed in-flight send depth never exceeds ``contexts`` and
      matches ``send_window_depths`` after every issue,
    * every in-flight send is retired (drained) by kernel end,
    * the receive-wait count equals ``completion_ticks``.
    """

    def __init__(self):
        self.events = []

    def reset(self):
        self.events = []

    def issue(self, edge, tile):
        self.events.append(("issue", int(edge), int(tile)))

    def wait_send(self):
        self.events.append(("wait_send",))

    def wait_recv(self, slot=None):
        self.events.append(("wait_recv",
                            None if slot is None else int(slot)))

    def mark(self, name):
        """Freeform ordering marker (e.g. the two-stream serving kernel
        stamps ``shared_ffn`` between the last dispatch issue and the
        window drain). Ignored by :meth:`check`; asserted via
        :attr:`marks` by callers that care about compute/DMA interleave."""
        self.events.append(("mark", str(name)))

    @property
    def marks(self):
        return [e[1] for e in self.events if e[0] == "mark"]

    @property
    def issued(self):
        return [(e[1], e[2]) for e in self.events if e[0] == "issue"]

    @property
    def recv_waits(self):
        return [e for e in self.events if e[0] == "wait_recv"]

    def check(self, schedule, contexts, counter=True):
        """Assert the observed order satisfies the schedule contract;
        returns a summary dict on success, raises ``AssertionError`` with
        the first divergence otherwise."""
        cap = max(1, int(contexts))
        rounds = list(schedule.rounds)
        assert self.issued == rounds, (
            f"observed issue order diverges from schedule.rounds:\n"
            f"  observed {self.issued[:8]}...\n  expected {rounds[:8]}...")
        depth, depths = 0, []
        for ev in self.events:
            if ev[0] == "issue":
                depth += 1
                assert depth <= cap, (
                    f"send window exceeded: depth {depth} > contexts {cap}")
                depths.append(depth)
            elif ev[0] == "wait_send":
                depth -= 1
                assert depth >= 0, "wait_send with no in-flight send"
        assert depth == 0, f"{depth} sends left in flight (window not drained)"
        expect = schedule.send_window_depths(cap)
        assert depths == list(expect), (
            f"window depth profile diverges from send_window_depths:\n"
            f"  observed {depths[:12]}...\n  expected {list(expect)[:12]}...")
        ticks = schedule.completion_ticks(counter) \
            if hasattr(schedule, "completion_ticks") else None
        n_recv = len(self.recv_waits)
        if ticks is not None:
            assert n_recv == ticks, (
                f"receive waits {n_recv} != completion_ticks {ticks}")
        return {"rounds": len(rounds), "max_depth": max(depths, default=0),
                "recv_waits": n_recv}
