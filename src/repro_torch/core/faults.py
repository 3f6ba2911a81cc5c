"""Fault model for the collective kernels — the injection/charging side of
the degraded-mode schedule layer (``core/schedule.py::degrade``).

Port copy of ``repro/core/faults.py``. A :class:`FaultSpec` names one
failure of the deployment the search must survive; a :class:`FaultPlan`
bundles the specs of one scenario. Plans are consumed at two cascade
levels:

* **l2** — a dropped peer is realized *structurally*: the workload
  reshapes onto the survivors (``Workload.degrade``), the schedules
  splice/respill the dead rank out, and the degraded kernel runs
  unmodified on the surviving mesh (a ``VirtualMesh`` of the survivors'
  width). Wire faults (:data:`CORRUPT_WIRE`/:data:`TRUNCATED_WIRE`) are
  applied to the kernel output via :func:`inject_wire_fault` so the
  evaluator's finite/rel-err checks must classify them. A delayed-DMA
  straggler has no l2 observable; it is charged at l3 and fed to the
  ``StragglerWatchdog`` as wall time.
* **l3 (analytic)** — :func:`fault_cost` prices the scenario: the degraded
  round count via the degraded workload's own ``analytic_cost``, the dead
  ranks' resident state re-materialized over the peer link (the recovery
  term that keeps a smaller mesh from modeling *cheaper* than the healthy
  one), a membership-rendezvous constant, and the straggler stall via
  ``window_stall_factor`` — a ``contexts``-deep send window hides all but
  ``1/contexts`` of each delayed round's blip.

:func:`survival_report` evaluates a plan set into the ``fault_report``
attached to ``EvalResult`` so the slow path can optimize a
(throughput, fault-survival) trade-off (``CascadeEvaluator(fault_weight=)``).

Pure Python except :func:`inject_wire_fault`, which takes a torch tensor,
or a tuple, list or dict of them, in place of the reference's jax pytree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.cost_model import window_stall_factor

__all__ = [
    "DROPPED_PEER", "STRAGGLER", "CORRUPT_WIRE", "TRUNCATED_WIRE",
    "FAULT_KINDS", "REMESH_OVERHEAD", "FaultSpec", "FaultPlan",
    "fault_cost", "survival_report", "inject_wire_fault",
]

DROPPED_PEER = "dropped_peer"        # rank leaves the membership for good
STRAGGLER = "straggler"              # rank's DMAs land late for some rounds
CORRUPT_WIRE = "corrupt_wire"        # payload arrives, contents are garbage
TRUNCATED_WIRE = "truncated_wire"    # payload arrives short (tail missing)
FAULT_KINDS = (DROPPED_PEER, STRAGGLER, CORRUPT_WIRE, TRUNCATED_WIRE)

# control-plane rendezvous to agree on the new membership and rebuild the
# schedules (a constant: the schedules are pure Python)
REMESH_OVERHEAD = 250e-6


@dataclass(frozen=True)
class FaultSpec:
    """One injected failure. ``rank`` is the victim; ``rounds``/``delay_s``
    size a straggler (delayed rounds and per-round added latency);
    ``rows`` sizes a wire fault (corrupted leading / truncated trailing
    rows of the payload)."""
    kind: str
    rank: int = 0
    rounds: int = 0
    delay_s: float = 0.0
    rows: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")


@dataclass(frozen=True)
class FaultPlan:
    """A named failure scenario: the fault set one candidate is scored
    against. Frozen and hashable so plans can key report dicts."""
    name: str
    faults: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    @property
    def healthy(self):
        return not self.faults

    def dropped(self):
        """Ranks the plan removes from the membership, sorted."""
        return tuple(sorted({f.rank for f in self.faults
                             if f.kind == DROPPED_PEER}))

    def live_ranks(self, n):
        """Surviving membership of an ``n``-rank deployment under this
        plan (may be empty — callers validate via ``check_live``)."""
        dead = set(self.dropped())
        return tuple(r for r in range(n) if r not in dead)

    def straggler_stall_s(self, contexts):
        """Modeled stall of the plan's delayed-DMA rounds under a
        ``contexts``-deep send window: the window floats past a late
        round, leaving ``window_stall_factor(contexts) - 1 = 1/contexts``
        of each blip exposed — deeper windows absorb stragglers, which is
        exactly the trade-off the search should see."""
        exposed = window_stall_factor(max(1, int(contexts))) - 1.0
        return sum(f.rounds * f.delay_s * exposed
                   for f in self.faults if f.kind == STRAGGLER)

    def wire_faults(self):
        return tuple(f for f in self.faults
                     if f.kind in (CORRUPT_WIRE, TRUNCATED_WIRE))


def fault_cost(workload, directive, hw, plan):
    """l3 cost of ``directive`` on ``workload`` under ``plan`` (seconds).

    Dropped peers reshape the workload onto the survivors
    (``workload.degrade``) and add the recovery charge: each dead rank's
    resident state (``state_bytes_per_rank``) re-materializes over the
    peer link (``ici_link_bw``), plus :data:`REMESH_OVERHEAD` for the
    membership rendezvous. Straggler rounds add the window-absorbed stall.
    Raises if the plan leaves no survivor — a scenario the deployment
    cannot degrade through."""
    n = workload.n_dev
    live = plan.live_ranks(n)
    if len(live) == n:
        t = workload.analytic_cost(directive, hw)
    else:
        from repro_torch.core.schedule import check_live
        live = check_live(live, n)       # raises on an empty survivor set
        degraded = workload.degrade(live)
        t = degraded.analytic_cost(directive, hw)
        dead = n - len(live)
        t += dead * workload.state_bytes_per_rank() / hw.chip.ici_link_bw
        t += REMESH_OVERHEAD
    return t + plan.straggler_stall_s(directive.contexts)


def survival_report(workload, directive, hw, plans):
    """Evaluate ``plans`` into the ``EvalResult.fault_report`` dict:
    ``{plan.name: {healthy_ms, degraded_ms, survives}}``. A plan the
    workload cannot degrade through (no survivors, no degraded reshape)
    reports ``survives=False`` with a diagnostic instead of raising — the
    cascade must never die on a fault scenario."""
    healthy_ms = workload.analytic_cost(directive, hw) * 1e3
    report = {}
    for plan in plans:
        try:
            ms = fault_cost(workload, directive, hw, plan) * 1e3
            survives = math.isfinite(ms)
            entry = {"healthy_ms": healthy_ms, "degraded_ms": ms,
                     "survives": survives}
        except Exception as e:
            entry = {"healthy_ms": healthy_ms, "degraded_ms": float("inf"),
                     "survives": False,
                     "diagnostic": f"{type(e).__name__}: {e}"}
        report[plan.name] = entry
    return report


def inject_wire_fault(out, spec):
    """Apply a wire fault to a kernel output (a tensor, or a tuple, list
    or dict of them — the l2 injection point): :data:`CORRUPT_WIRE`
    poisons the leading ``spec.rows`` rows (axis 0) of every floating
    tensor with NaN (the evaluator's finite check must flag it);
    :data:`TRUNCATED_WIRE` zeroes the trailing rows (the rel-err check
    must flag it). Other tensors pass through untouched; the output is
    never written in place."""
    import torch

    if spec.kind not in (CORRUPT_WIRE, TRUNCATED_WIRE):
        raise ValueError(f"not a wire fault: {spec.kind!r}")

    def hit(leaf):
        if not isinstance(leaf, torch.Tensor) \
                or not torch.is_floating_point(leaf) or leaf.dim() == 0:
            return leaf
        rows = max(1, min(int(spec.rows), leaf.shape[0]))
        leaf = leaf.clone()
        if spec.kind == CORRUPT_WIRE:
            leaf[:rows] = float("nan")
        else:
            leaf[leaf.shape[0] - rows:] = 0.0
        return leaf

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return hit(x)

    return walk(out)
