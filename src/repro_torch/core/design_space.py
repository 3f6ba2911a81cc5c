"""The structured co-design configuration space C (paper §3.1, Appendix B),
adapted to TPU (DESIGN.md §2).

C = B x M x P x S x I x G x O x K

Concrete dimensions map to real JAX/Pallas mechanisms; intent dimensions are
realized by the workload builders. Expert-crafted systems are points in this
space (paper Table 3) — reproduced below with their TPU-adapted coordinates.

The agents never emit free-form programs: a candidate IS a Directive (+ its
numeric tunables), and the workload's builder realizes it. This is the
paper's core claim — "LLMs as bounded operators over domain-defined search
spaces" — with the bounding enforced by construction.

Port copy of ``repro/core/design_space.py`` (the directive vocabulary is
shared, so directives cross between the packages unchanged).
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, replace

# ---------------------------------------------------------------- dimensions

BACKENDS = ("XLA_COLLECTIVE", "PALLAS_RDMA", "HYBRID")
# paper: GIN | LSA | Hybrid.  TPU: XLA-level collectives (host-driven
# analogue is "deferred XLA collective"), Pallas remote DMA (device-initiated
# — the GIN analogue; same-ICI-domain neighbor stores are the closest LSA
# analogue), HYBRID = Pallas intra-pod + XLA cross-pod.

COMPLETIONS = ("BARRIER", "SIGNAL", "SIGNAL_SHADOW", "COUNTER")
# BARRIER  -> global semaphore barrier after transfers
# SIGNAL   -> per-edge DMA recv semaphores (point-to-point wait)
# SIGNAL_SHADOW -> signal + locally-cached count (skip re-polling)
# COUNTER  -> SMEM/atomic counters for intra-kernel per-tile readiness

PLACEMENTS = ("DEFERRED", "TILE_FUSED", "TILE_PIPELINED", "STREAM_SPLIT")
# DEFERRED  -> comm strictly after compute (host-driven shape)
# TILE_FUSED -> comm issued inside the compute kernel per tile
# TILE_PIPELINED -> DMA for tile j+1 in flight while computing tile j
# STREAM_SPLIT -> dependence-free XLA scheduling (async collective overlaps
#                 an independent compute chain — the two-stream analogue)

SCOPES = ("LOCAL", "WORLD", "RAIL", "HIERARCHICAL")
# LOCAL -> intra-pod (ICI domain); WORLD -> all chips incl. DCN;
# RAIL -> same mesh row/col; HIERARCHICAL -> intra-pod then cross-pod phases

ISSUERS = ("KERNEL", "GRID_STEP", "CHUNKED")
# TPU has no warps/CTAs: the issuer is the loop level that starts the DMA —
# once per kernel, once per grid step (per tile), or per sub-chunk.

GRANULARITIES = ("PER_PEER", "PER_TILE", "PER_CHUNK")

ORDERINGS = ("RELAXED", "ACQUIRE", "RELEASE", "ACQREL")
# TPU reading: where semaphore waits sit relative to compute. RELAXED =
# defer waits to the last moment (max reordering), RELEASE = sender flushes
# before signaling, ACQUIRE = receiver waits before any dependent read,
# ACQREL = both (fully eager waits).

CONTEXTS = (1, 2, 4)
# number of in-flight communication buffers (double/quad buffering depth)

# ------------------------------------------------- numeric tunable space
# Central candidate grids for the slow path's diff-patch (exploit) mutation
# form: these refine *within* a behavior cell of the archive. Workloads
# whose default_tunables() name one of these knobs get the grid below;
# ``contexts`` mirrors the directive dimension so a fine-grained diff can
# retune the send-window depth without a placement move.
TUNABLES = {
    "block_tokens": (16, 32, 64, 128, 256),   # microblock rows per DMA round
    "chained": (0, 1),                        # kv_shuttle K→V signal chain
    "combine_tile": (8, 16, 32, 64, 128),     # fused-combine GEMM tile rows
    "contexts": CONTEXTS,                     # in-flight send window depth
    "kv_chunk": (16, 32, 64, 128, 256),       # ring rotation chunk rows
    "tight": (0, 1),                          # exact vs padded wire sizes
    "tile_m": (16, 32, 64, 128, 256),         # gemm_allgather GEMM tile rows
    "wire_i8": (0, 1),                        # int8 dispatch wire
}
# grid values need not divide a given workload shape: consumers sanitize at
# their own boundary (core/schedule.py::sanitize_tile and its per-knob
# aliases) so a diff-patch mutation can never crash the evaluator.

DIMENSIONS = {
    "backend": BACKENDS,
    "completion": COMPLETIONS,
    "placement": PLACEMENTS,
    "scope": SCOPES,
    "issuer": ISSUERS,
    "granularity": GRANULARITIES,
    "ordering": ORDERINGS,
    "contexts": CONTEXTS,
}


@dataclass(frozen=True)
class Directive:
    """One point in C. Emitted by every agent BEFORE any code is built
    (paper Appendix G) — making design decisions inspectable."""
    backend: str = "XLA_COLLECTIVE"
    completion: str = "BARRIER"
    placement: str = "DEFERRED"
    scope: str = "WORLD"
    issuer: str = "KERNEL"
    granularity: str = "PER_PEER"
    ordering: str = "RELEASE"
    contexts: int = 1
    # numeric tunables refined by diff-patch mutations
    tunables: tuple = ()             # sorted ((name, value), ...)

    def tunable(self, name, default=None):
        return dict(self.tunables).get(name, default)

    def with_tunable(self, name, value):
        d = dict(self.tunables)
        d[name] = value
        return replace(self, tunables=tuple(sorted(d.items())))

    def as_dict(self):
        d = {k: getattr(self, k) for k in DIMENSIONS}
        d["tunables"] = dict(self.tunables)
        return d

    def render(self):
        """The literal optimization-directive block (paper Appendix G)."""
        lines = ["OPTIMIZATION DIRECTIVE"]
        for k in DIMENSIONS:
            lines.append(f"  {k:12s} = {getattr(self, k)}")
        for n, v in self.tunables:
            lines.append(f"  tunable {n} = {v}")
        return "\n".join(lines)

    @property
    def behavior(self):
        """MAP-Elites behavioral descriptor (backend, placement, completion)."""
        return (self.backend, self.placement, self.completion)


def directive_key(d: Directive) -> str:
    """Canonical identity of a point in C: the ``as_dict`` form, JSON-encoded
    with sorted keys. Two directives that realize the same configuration map
    to the same key regardless of tunables-tuple ordering — this is the
    novelty-filter index key (``core/database.py``) and, combined with the
    workload + hardware fingerprints, the warm-start eval-cache key
    (docs/search.md)."""
    import json
    return json.dumps(d.as_dict(), sort_keys=True)


def directive_from_dict(obj: dict) -> Directive:
    """Inverse of :meth:`Directive.as_dict` — the persistence decoder for
    ``CandidateDB.load`` / ``MapElitesArchive.load``."""
    kw = {k: obj[k] for k in DIMENSIONS}
    kw["contexts"] = int(kw["contexts"])
    tun = obj.get("tunables", {})
    return Directive(**kw, tunables=tuple(sorted(tun.items())))


CONSERVATIVE = Directive(
    backend="XLA_COLLECTIVE", completion="BARRIER", placement="DEFERRED",
    scope="WORLD", issuer="KERNEL", granularity="PER_PEER",
    ordering="RELEASE", contexts=1,
)
# The fast-path agent always emits this fixed conservative directive (§3.2):
# deterministic, collective-semantic, zero overlap — correctness first.


# -------------------------------------------------- validity (bounded space)

def violations(d: Directive, *, has_dcn=False, kernelizable=True,
               ring_topology=False) -> list:
    """Semantic constraints that bound the agents' degrees of freedom.
    An empty list means the directive is realizable for the workload/hardware.
    """
    v = []
    if d.backend not in BACKENDS:
        v.append(f"unknown backend {d.backend}")
    if d.completion not in COMPLETIONS or d.placement not in PLACEMENTS \
            or d.scope not in SCOPES or d.issuer not in ISSUERS \
            or d.granularity not in GRANULARITIES or d.ordering not in ORDERINGS:
        v.append("unknown dimension value")
    if d.contexts not in CONTEXTS:
        v.append(f"contexts must be one of {CONTEXTS}")
    if d.backend == "XLA_COLLECTIVE":
        if d.completion in ("SIGNAL", "SIGNAL_SHADOW", "COUNTER"):
            v.append("XLA collectives are barrier-semantic: point-to-point "
                     "completion requires PALLAS_RDMA")
        if d.placement in ("TILE_FUSED", "TILE_PIPELINED"):
            v.append("in-kernel placement requires PALLAS_RDMA backend")
        if d.issuer != "KERNEL":
            v.append("XLA collectives are issued once per op (KERNEL issuer)")
    if d.backend in ("PALLAS_RDMA", "HYBRID"):
        if not kernelizable:
            v.append("workload has no Pallas kernelization")
        if d.placement == "DEFERRED" and d.completion == "COUNTER":
            v.append("COUNTER completion only meaningful inside a fused kernel")
    if d.backend == "PALLAS_RDMA" and has_dcn and d.scope == "WORLD":
        v.append("Pallas RDMA is ICI-only: WORLD scope across DCN requires "
                 "HYBRID or XLA_COLLECTIVE")
    if d.placement == "TILE_PIPELINED" and d.contexts < 2:
        v.append("pipelined placement needs >=2 buffers (contexts)")
    if d.placement in ("TILE_FUSED", "TILE_PIPELINED") \
            and d.granularity == "PER_PEER" and ring_topology:
        v.append("fused ring kernels exchange PER_TILE/PER_CHUNK, not PER_PEER")
    if d.completion == "COUNTER" and d.placement not in ("TILE_FUSED",):
        v.append("COUNTER requires TILE_FUSED placement")
    if d.scope == "HIERARCHICAL" and not has_dcn:
        v.append("HIERARCHICAL scope needs a multi-pod mesh")
    return v


def is_valid(d: Directive, **traits) -> bool:
    return not violations(d, **traits)


def random_directive(rng: random.Random, **traits) -> Directive:
    """Rejection-sample a valid directive (bounded-operator fallback)."""
    for _ in range(200):
        d = Directive(
            backend=rng.choice(BACKENDS),
            completion=rng.choice(COMPLETIONS),
            placement=rng.choice(PLACEMENTS),
            scope=rng.choice(SCOPES),
            issuer=rng.choice(ISSUERS),
            granularity=rng.choice(GRANULARITIES),
            ordering=rng.choice(ORDERINGS),
            contexts=rng.choice(CONTEXTS),
        )
        if is_valid(d, **traits):
            return d
    return CONSERVATIVE


def enumerate_valid(**traits):
    for combo in itertools.product(BACKENDS, COMPLETIONS, PLACEMENTS, SCOPES,
                                   ISSUERS, GRANULARITIES, ORDERINGS, CONTEXTS):
        d = Directive(*combo)
        if is_valid(d, **traits):
            yield d


# ------------------------------------------- expert systems as points in C
# (paper Table 3, TPU-adapted coordinates)

EXPERT_SYSTEMS = {
    "DeepEP (NVL)": Directive("PALLAS_RDMA", "BARRIER", "DEFERRED", "LOCAL",
                              "KERNEL", "PER_PEER", "RELEASE", 1),
    "DeepEP (IB)": Directive("PALLAS_RDMA", "SIGNAL", "DEFERRED", "WORLD",
                             "KERNEL", "PER_PEER", "ACQUIRE", 1),
    # FLUX / CoCoNet point: the GEMM tile loop fused with per-tile
    # communication — COUNTER readiness ticks per output tile
    "FLUX": Directive("PALLAS_RDMA", "COUNTER", "TILE_FUSED", "LOCAL",
                      "GRID_STEP", "PER_TILE", "ACQREL", 1),
    "TokenWeave": Directive("XLA_COLLECTIVE", "BARRIER", "STREAM_SPLIT",
                            "LOCAL", "KERNEL", "PER_CHUNK", "RELEASE", 2),
}
