"""The send window of the port's cooperative kernels, from the host side
(``csrc/window.cuh``): the ``contexts`` check every wrapper makes before a
launch, and the op recorder of the probe builds.

A kernel built with ``-DCUCO_PROBE`` (:data:`PROBE_DEFINES`) has each CTA
append its window events to a device log the wrapper allocates
(:class:`DeviceLog`): push ``(edge, tile)``, retire, receive wait, drain
and marks, each stamped with the low 32 bits of ``%globaltimer``.
:func:`decode` turns each CTA's log into events of the reference's
``core/trace.py::ScheduleProbe`` vocabulary (``("issue", edge, tile)``,
``("wait_send",)``, ``("wait_recv", edge, chunk)``, ``("mark", name)``,
plus ``("drain", point)``), each with its time last, and refuses a log
that overflowed. :func:`check_cta` holds one CTA's window to the
reference's contract (depth never over the cap, the depth profile equal
to ``send_window_depths`` of its rounds between drain points, drained at
every drain point and at the end, rounds in the schedule's order) and
:func:`check_rank` a rank's CTAs together (the union of their rounds is
the rank's rounds; the receive waits add up to ``completion_ticks``).
Each kernel module maps its CTAs' rounds onto its schedule
(``check_log``) and says where the card's round differs from the
reference's.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.design_space import CONTEXTS
from repro_torch.core.schedule import send_window_depths

PROBE_DEFINES = ("CUCO_PROBE",)
EV_PUSH, EV_RETIRE, EV_RECV, EV_MARK, EV_DRAIN = 1, 2, 3, 4, 5
# window.cuh's MARK_* in order: the reference's moe probe marks
MARKS = ("dispatch_issued", "shared_ffn", "dispatch_drained")


def check_contexts(contexts):
    """``contexts`` as an int; raises unless it is one of the directive
    space's ``CONTEXTS`` (1, 2 or 4): a wrapper calls this before any
    launch."""
    if isinstance(contexts, bool) or int(contexts) != contexts \
            or int(contexts) not in CONTEXTS:
        raise ValueError(f"contexts must be one of {CONTEXTS}, got "
                         f"{contexts!r}")
    return int(contexts)


class LogOrStats(ctypes.Union):
    """One slot of a kernel's parameter struct: ``log`` (the probe build's
    window log, :class:`DeviceLog`) or ``stats`` (the counting build's
    cycle counters, ``core/telemetry.py::kernel_counters``); null in the
    production build. A ``_Params`` takes it as anonymous field ``slot``,
    so both names set it."""
    _fields_ = [("log", ctypes.c_void_p), ("stats", ctypes.c_void_p)]


class WindowLogError(AssertionError):
    """A probe log that breaks the send-window contract, or overflowed."""


@dataclasses.dataclass
class DeviceLog:
    """A launch's probe log: ``events`` (grid, cap, 4) int32 and
    ``counts`` (grid,) int32, zeroed; the kernel's ``log``, ``log_n`` and
    ``log_cap`` parameters point into it."""
    events: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def alloc(cls, grid, cap, device):
        return cls(torch.zeros((grid, cap, 4), dtype=torch.int32,
                               device=device),
                   torch.zeros(grid, dtype=torch.int32, device=device))

    @property
    def cap(self):
        return self.events.shape[1]

    def params(self):
        """``dict(log=..., log_n=..., log_cap=...)`` for a parameter struct."""
        return dict(log=self.events.data_ptr(), log_n=self.counts.data_ptr(),
                    log_cap=self.cap)


def decode(events, counts):
    """Each CTA's events, in the order it appended them, from a log's
    ``events`` (grid, cap, 4) and ``counts`` (grid,): a list a CTA of
    ``("issue", edge, tile, t)``, ``("wait_send", t)``, ``("wait_recv",
    edge, chunk, t)``, ``("mark", name, t)`` and ``("drain", point, t)``
    (``t`` in ns, modulo 2^32). Raises :class:`WindowLogError` when a CTA
    appended more events than its log holds."""
    counts = [int(c) for c in counts.cpu().tolist()]
    cap = events.shape[1]
    for cta, c in enumerate(counts):
        if c > cap:
            raise WindowLogError(f"CTA {cta} appended {c} events to a log "
                                 f"of {cap}: the log overflowed")
    rows = events.cpu()
    out = []
    for cta, c in enumerate(counts):
        evs = []
        for kind, a, b, t in rows[cta, :c].tolist():
            t &= 0xFFFFFFFF
            if kind == EV_PUSH:
                evs.append(("issue", a, b, t))
            elif kind == EV_RETIRE:
                evs.append(("wait_send", t))
            elif kind == EV_RECV:
                evs.append(("wait_recv", a, b, t))
            elif kind == EV_MARK:
                evs.append(("mark", MARKS[a], t))
            elif kind == EV_DRAIN:
                evs.append(("drain", a, t))
            else:
                raise WindowLogError(f"CTA {cta}: unknown event kind {kind}")
        out.append(evs)
    return out


def probe_events(events):
    """One CTA's decoded events as a ``ScheduleProbe``'s ``events``: times
    and drains dropped, a receive wait's slot its edge."""
    out = []
    for ev in events:
        if ev[0] == "issue":
            out.append(("issue", ev[1], ev[2]))
        elif ev[0] == "wait_send":
            out.append(("wait_send",))
        elif ev[0] == "wait_recv":
            out.append(("wait_recv", ev[1]))
        elif ev[0] == "mark":
            out.append(("mark", ev[1]))
    return out


def pushed(events):
    """The rounds ``(edge, tile)`` a CTA pushed, in order."""
    return [(ev[1], ev[2]) for ev in events if ev[0] == "issue"]


def segments(events):
    """The rounds a CTA pushed between its drain points, a count each."""
    counts = [0]
    for ev in events:
        if ev[0] == "issue":
            counts[-1] += 1
        elif ev[0] == "drain":
            counts.append(0)
    return counts


def check_cta(events, contexts, order=None, where=""):
    """Hold one CTA's decoded events to the window contract: the depth
    never over ``contexts``; the depth after each push equal to
    ``send_window_depths`` of the rounds pushed since the last drain
    point; zero at every drain point and at the end; and, with ``order``
    (the schedule's rounds), the pushed rounds a subsequence of it, each
    once. Returns ``{"rounds", "max_depth", "recv", "drains"}``; raises
    :class:`WindowLogError` with the first breach."""
    cap = check_contexts(contexts)
    depth, depths, expect, seg, drains = 0, [], [], 0, 0
    for ev in events:
        if ev[0] == "issue":
            depth += 1
            if depth > cap:
                raise WindowLogError(f"{where}send window exceeded: depth "
                                     f"{depth} > contexts {cap}")
            depths.append(depth)
            seg += 1
        elif ev[0] == "wait_send":
            depth -= 1
            if depth < 0:
                raise WindowLogError(f"{where}a retire with no round in "
                                     "flight")
        elif ev[0] == "drain":
            if depth:
                raise WindowLogError(f"{where}{depth} rounds in flight at "
                                     f"drain point {ev[1]}: not drained")
            expect += send_window_depths(range(seg), cap)
            seg, drains = 0, drains + 1
    if depth:
        raise WindowLogError(f"{where}{depth} rounds left in flight at the "
                             "end: the window was not drained")
    expect += send_window_depths(range(seg), cap)
    if depths != expect:
        raise WindowLogError(f"{where}depth profile {depths[:12]}... differs "
                             f"from send_window_depths {expect[:12]}...")
    rounds = pushed(events)
    if order is not None:
        check_order(rounds, order, where)
    return {"rounds": len(rounds), "max_depth": max(depths, default=0),
            "recv": sum(ev[0] == "wait_recv" for ev in events),
            "drains": drains}


def check_order(rounds, order, where=""):
    """``rounds`` a subsequence of ``order`` (the schedule's rounds), each
    once."""
    index = {tuple(r): i for i, r in enumerate(order)}
    last = -1
    for r in rounds:
        i = index.get(tuple(r))
        if i is None:
            raise WindowLogError(f"{where}round {r} is not in the schedule")
        if i <= last:
            raise WindowLogError(f"{where}round {r} out of the schedule's "
                                 "order")
        last = i


def check_rank(ctas, rounds, ticks=None, per_cta_ticks=False, where=""):
    """Hold a rank's CTAs' events together: the union of the rounds they
    pushed is ``rounds``; the receive waits are ``ticks`` (each CTA's, with
    ``per_cta_ticks``: every CTA waits on every flag; else their sum)."""
    got = set()
    for evs in ctas:
        got.update(map(tuple, pushed(evs)))
    want = set(map(tuple, rounds))
    if got != want:
        missing, extra = sorted(want - got), sorted(got - want)
        raise WindowLogError(f"{where}rounds differ from the rank's: missing "
                             f"{missing[:6]}, extra {extra[:6]}")
    if ticks is not None:
        recv = [sum(ev[0] == "wait_recv" for ev in evs) for evs in ctas]
        if per_cta_ticks:
            bad = [r for r in recv if r != ticks]
            if bad:
                raise WindowLogError(f"{where}a CTA waited {bad[0]} times, "
                                     f"not completion_ticks {ticks}")
        elif sum(recv) != ticks:
            raise WindowLogError(f"{where}receive waits {sum(recv)} != "
                                 f"completion_ticks {ticks}")


def summary(stats):
    """``{"ctas", "rounds", "max_depth"}`` over :func:`check_cta` results."""
    return {"ctas": len(stats),
            "rounds": sum(s["rounds"] for s in stats),
            "max_depth": max((s["max_depth"] for s in stats), default=0)}
