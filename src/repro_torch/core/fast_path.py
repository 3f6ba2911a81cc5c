"""Fast-path agent (paper §3.2, Appendix D): correctness-first transformation
of the host-driven baseline into a verified device-initiated seed.
Port of ``repro/core/fast_path.py``.

  1. Code analysis: run the host baseline once under the recorder
     (``core/comm_graph.py``) to recover its communication graph.
  2. Host-to-device transformation, two judge-checked stages:
       Stage A (communication setup): check the directive against the
         workload, build the program, and build and load the kernel it
         launches without running it.
       Stage B (communication replacement): evaluate the device-initiated
         program under the FIXED conservative directive through the
         cascade (l0-l3). On failure the next legal fallback is tried.
  3. Evolve-block annotation: the verified seed carries the mutable
     design-space dimensions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core import comm_graph
from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.design_space import CONSERVATIVE, Directive


@dataclass
class VerifiedSeed:
    workload: object
    directive: Directive
    candidate: Candidate
    graph: object                       # CommGraph of the host baseline
    evolve_dims: tuple
    log: list = field(default_factory=list)


DEVICE_CONSERVATIVE = dataclasses.replace(
    CONSERVATIVE, backend="PALLAS_RDMA")
# Stage B's fixed conservative directive, device-initiated flavour:
# in-kernel DEFERRED placement, BARRIER completion, WORLD scope, KERNEL
# issuer, PER_PEER granularity, RELEASE ordering, single context.


def fast_path(workload, mesh, hw, *, evaluator=None, max_iters=3,
              verbose=False):
    """Returns a VerifiedSeed. Raises RuntimeError if no conservative
    directive verifies within the iteration budget."""
    log = []
    ev = evaluator or CascadeEvaluator(workload, mesh, hw)

    # -- step 1: analysis of the host-driven baseline ----------------------
    host = workload.host_baseline(mesh)
    graph = comm_graph.analyze(host, *ev.inputs)
    log.append(f"analyzer: {len(graph.nodes)} collectives / "
               f"{graph.n_eqns} ops; {graph.collective_bytes} payload bytes")
    if verbose:
        print(graph.describe())

    # -- step 2: staged transformation under conservative directives -------
    trial_order = [DEVICE_CONSERVATIVE, CONSERVATIVE]
    if not workload.kernelizable:
        trial_order = [CONSERVATIVE]
    last_diag = ""
    for it, d in enumerate(trial_order * max_iters):
        d = dataclasses.replace(
            d, tunables=tuple(sorted(workload.default_tunables().items())))
        viol = workload.check(d, hw)
        if viol:
            log.append(f"stage A reject {d.backend}: {viol}")
            continue
        # Stage A: the program builds and its kernel builds and loads
        try:
            workload.build(d, mesh)
            built = workload.load_kernels(d, mesh)
            log.append(f"stage A ok: {d.backend} infrastructure builds "
                       f"({built})")
        except Exception as e:  # judge: route the root cause to the next try
            last_diag = f"stage A failed ({d.backend}): {e}"
            log.append(last_diag)
            continue
        # Stage B: semantic replacement, verified vs the oracle
        cand = Candidate(directive=d, mutation="fast-path-seed")
        res = ev.evaluate(cand)
        cand.result = res
        if res.ok:
            log.append(f"stage B verified on iteration {it + 1}: "
                       f"score {res.score:.2f}")
            # step 3: evolve-block annotation
            return VerifiedSeed(workload=workload, directive=d,
                                candidate=cand, graph=graph,
                                evolve_dims=workload.evolve_dims, log=log)
        last_diag = res.diagnostic
        log.append(f"stage B failed (judge): {last_diag}")
    raise RuntimeError("fast path could not produce a verified seed:\n"
                       + "\n".join(log))
