"""Workload protocol for the co-design search.

A workload exposes:
  * ``reference``       — plain-torch oracle over the stacked (n, ...) rank layout,
  * ``host_baseline``   — the host-driven input program (mesh collectives,
                          strictly sequenced; what a user writes before
                          device-initiated redesign),
  * ``build(directive)``— the directive-realized implementation (the bounded
                          operator's output),
  * ``kernel_knobs``    — the single directive→kernel-knob mapping both
                          ``build()`` and ``analytic_cost()`` consult for
                          the kernelized (PALLAS_RDMA/HYBRID) points: the
                          search contract of docs/kernels.md. The base
                          default maps every ``default_tunables()`` entry
                          (directive tunables win — the grids live in
                          ``design_space.TUNABLES``) plus the shared
                          ``contexts`` dimension; workloads override to add
                          their placement/completion realizations, and
  * ``analytic_cost``   — the l3 roofline model of one step at the paper's
                          full deployment shape, priced on the context's
                          ``ChipSpec`` (the cascade adds CUDA-event wall
                          time on the card with ``wallclock=True``).

Builders must be *semantics-preserving*: every directive that validates for
the workload's traits produces the same numbers (cascade l2 checks this).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.design_space import Directive, violations

WORKLOADS = {}


def register(cls):
    WORKLOADS[cls.name] = cls
    return cls


def get_workload(name: str, **kw):
    return WORKLOADS[name](**kw)


def inputs_from_numpy(*arrays, device="cuda"):
    """A JAX workload's inputs, as numpy arrays in its layout, as float32
    tensors on ``device`` — how the tests hand one set of inputs to both
    packages."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in arrays)


# rough per-event overheads (seconds) used by the analytic l3 model
BARRIER_OVERHEAD = 2e-6          # global rendezvous per occurrence
SIGNAL_OVERHEAD = 0.3e-6         # point-to-point semaphore wait
KERNEL_LAUNCH = 4e-6             # host-driven launch gap per phase
TILE_SYNC = 0.5e-6               # per-tile counter/semaphore check


@dataclass
class Workload:
    name = "abstract"
    ring_topology = False
    kernelizable = True

    # dimensions the evolve-block annotation marks as mutable
    evolve_dims = ("backend", "completion", "placement", "ordering",
                   "granularity", "contexts", "issuer", "scope")

    def traits(self, hw=None):
        return dict(kernelizable=self.kernelizable,
                    ring_topology=self.ring_topology,
                    has_dcn=bool(hw and hw.has_dcn))

    def check(self, d: Directive, hw=None):
        return violations(d, **self.traits(hw))

    # --- to implement ---
    def example_inputs(self, key, mesh):
        raise NotImplementedError

    def reference(self, *inputs):
        raise NotImplementedError

    def host_baseline(self, mesh):
        raise NotImplementedError

    def build(self, directive: Directive, mesh):
        raise NotImplementedError

    def analytic_cost(self, directive: Directive, hw) -> float:
        raise NotImplementedError

    def cost_breakdown(self, directive: Directive, hw):
        """Ordered ``CostSegment`` decomposition of ``analytic_cost`` — the
        auditable form ``core/trace.py::schedule_timeline`` renders. The
        four shipped workloads implement this and derive ``analytic_cost``
        from ``CostBreakdown.total`` (so trace critical path == l3 scalar by
        construction); the base default wraps a directly-implemented
        ``analytic_cost`` in a single opaque segment so third-party
        workloads stay traceable without opting in."""
        from repro_torch.core.cost_model import CostBreakdown, CostSegment
        return CostBreakdown(segments=(
            CostSegment("analytic_total", float(self.analytic_cost(directive, hw)),
                        "total"),))

    def default_tunables(self):
        return {}

    def fingerprint(self) -> str:
        """Stable identity of this workload *instance* (class name + scalar
        shape attributes) — the workload half of the warm-start eval-cache
        key (docs/search.md). Two instances with the same deployment shape
        fingerprint identically; a different shape (or workload) never
        reuses a cached score."""
        attrs = {k: v for k, v in vars(self).items()
                 if not k.startswith("_")
                 and isinstance(v, (int, float, str, bool))}
        body = ",".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        return f"{self.name}|{body}"

    # --- the fault contract (core/faults.py, docs/kernels.md) ---
    def degrade(self, live_ranks):
        """Membership-aware reshape onto the surviving ranks: a **smaller
        workload of the same class** whose schedules, builders and l3
        model all run at ``n = len(live_ranks)`` (compaction renumbering,
        mirroring ``CollectiveSchedule.degrade``). ``fault_cost`` prices a
        dropped-peer plan through this; the fault suite runs the degraded
        build through the full cascade on the surviving mesh."""
        raise NotImplementedError(
            f"{self.name} has no degraded-mode reshape")

    def state_bytes_per_rank(self) -> int:
        """Resident bytes one rank holds at the deployment shape — the
        recovery term of ``fault_cost``: a dead rank's state must
        re-materialize over ICI before the degraded step can run, which
        keeps a smaller mesh from ever modeling *cheaper* than health."""
        raise NotImplementedError

    # --- the search contract (docs/kernels.md) ---
    def kernel_knobs(self, d: Directive) -> dict:
        """Directive → kernel-knob mapping, shared by ``build()`` and
        ``analytic_cost()`` so the two can never drift. The base default
        resolves every default tunable against the directive (raw values:
        consumers sanitize shape-dependent knobs at their own boundary via
        ``core/schedule.py::sanitize_tile``) plus the ``contexts``
        send-window depth. Overrides call ``super().kernel_knobs(d)`` and
        add their realization knobs."""
        k = {name: d.tunable(name, default)
             for name, default in self.default_tunables().items()}
        k["contexts"] = max(1, int(d.contexts))
        return k

    def load_kernels(self, d: Directive, mesh) -> str:
        """Build and load (without running) the kernels ``build(d, mesh)``
        launches on ``mesh.device`` — the cascade's l1 and the fast path's
        stage A. Returns a one-line description of what was built; raises
        when a kernel cannot be built. The default build launches none."""
        del d
        return f"torch build on {mesh.device}"

    def collective_schedule(self, d: Directive):
        """The trace-time ``CollectiveSchedule`` the directive's build
        would issue, or ``None`` when the realization has no collective
        schedule at all (XLA backends, the kv solo tier) — then l0 static
        verification (``core/verify.py::verify_directive``) is vacuous.
        Overrides must return exactly the schedule the kernel iterates,
        built from the same ``kernel_knobs``, so the verifier and the
        kernel cannot drift."""
        del d
        return None
