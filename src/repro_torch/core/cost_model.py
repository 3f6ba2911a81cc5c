"""The roofline cost model and the auditable l3 cost breakdown (port of
``repro/core/cost_model.py``).

Three terms per chip, as in the reference:
  compute    = FLOPs / peak_bf16_flops
  memory     = bytes / hbm_bw
  collective = sum(per-op wire bytes) / link_bw   (pod-crossing ops charged
               at dcn_bw; all-reduce counts 2(n-1)/n, gather/scatter/a2a
               (n-1)/n, permute 1x)

The reference reads FLOPs and bytes from ``compiled.cost_analysis()`` and
the collectives from the HLO text. The port has no compiled module: it
reads a torch trace (``core/op_count.py``, on meta tensors or on the
card), and :func:`parse_collectives` reads the ``VirtualMesh`` recorder's
``CollectiveEvent`` records. The trace counts the whole program, every
rank of the mesh together, and the port runs its dense operators whole on
one device (no partitioner): per-device work is the whole divided by the
ranks, and the only collectives are those the program runs (the MoE
layers'). ``conversion_overhead_bytes`` has no counterpart: it takes off
XLA:CPU's f32 promotion of bf16 weights, and no op of a torch trace is
such a promotion (the port's own f32 copies, the MoE bodies' f32 FFNs
among them, run on the card and stay in the count), so
``convert_overhead`` is 0 and ``memory_corrected_s`` equals ``memory_s``.

The breakdown half (``CostSegment``, ``CostBreakdown``,
``per_tile_exposed_s``, ``window_stall_factor``) is a copy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.hardware import ChipSpec, H100

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)


@dataclass
class CollectiveOp:
    kind: str
    payload_bytes: int            # max(result, operands) payload per device
    group_size: int
    crosses_pod: bool
    wire_bytes: float             # effective bytes on the wire per device

    def describe(self):
        where = "DCN" if self.crosses_pod else "ICI"
        return (f"{self.kind:20s} {self.payload_bytes/2**20:9.2f} MiB "
                f"group={self.group_size:4d} {where} "
                f"wire={self.wire_bytes/2**20:9.2f} MiB")


SEGMENT_KINDS = ("compute", "wire", "overlap", "stall", "sync", "launch",
                 "quant", "recovery", "remesh", "total")


@dataclass(frozen=True)
class CostSegment:
    """One named slice of the modeled critical path. ``kind`` categorizes
    the slice for the trace renderer (``SEGMENT_KINDS``); ``meta`` carries
    free-form detail (e.g. the compute/wire terms an ``overlap`` span
    hides)."""
    name: str
    dur_s: float
    kind: str = "compute"
    meta: dict = field(default_factory=dict)


@dataclass(frozen=True)
class CostBreakdown:
    """The ordered decomposition of one directive's l3 analytic cost.

    ``total`` is the plain left-fold sum of the segments — workloads return
    it from ``analytic_cost``. ``schedule`` (when the directive is
    kernelized) is the trace-time ``CollectiveSchedule`` the kernel issues;
    ``knobs`` is the ``kernel_knobs`` mapping that built it."""
    segments: tuple
    schedule: object = None       # CollectiveSchedule | None
    knobs: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @property
    def total(self) -> float:
        return sum(s.dur_s for s in self.segments)

    def segment(self, name):
        for s in self.segments:
            if s.name == name:
                return s
        raise KeyError(name)


def per_tile_exposed_s(wire_bytes, link_bw, tiles) -> float:
    """Per-tile fused-communication credit (the FLUX/CoCoNet TILE_FUSED
    point): when a transfer is issued per output tile from inside the
    compute loop, tile t's wire time hides behind the compute of tile t+1
    and only the final tile's transfer stays exposed on the critical path.
    """
    return wire_bytes / link_bw / max(1, int(tiles))


def window_stall_factor(contexts) -> float:
    """Send-window recycle stall of a ``contexts``-deep in-flight window:
    the oldest send must drain before the next round may issue, leaving
    ~``1/contexts`` of a tile's wire unhidden. Scales the per-tile exposed
    tail in every kernelized TILE_FUSED cost model."""
    return 1.0 + 1.0 / max(1, int(contexts))


def _wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * f
    if kind == "collective-permute" or kind == "collective-broadcast":
        return 1.0
    return f                       # all-gather, reduce-scatter, all-to-all


def parse_collectives(events, mesh, chips_per_pod: int = 0):
    """The recorder's ``CollectiveEvent`` records (``dist.mesh.record``) as
    :class:`CollectiveOp`: kind and per-rank payload (the larger of operand
    and result, as the reference takes it from the HLO) from the event,
    group size ``mesh.size(axis)``; an op crosses a pod where its axes
    include ``"pod"`` and ``chips_per_pod`` is given."""
    ops = []
    for ev in events:
        axes = (ev.axis,) if isinstance(ev.axis, str) else tuple(ev.axis)
        gsize = mesh.size(axes)
        payload = max(ev.payload_bytes, ev.result_bytes)
        ops.append(CollectiveOp(
            kind=ev.kind, payload_bytes=payload, group_size=gsize,
            crosses_pod=bool(chips_per_pod) and "pod" in axes,
            wire_bytes=payload * _wire_factor(ev.kind, gsize)))
    return ops


@dataclass
class RooflineReport:
    flops: float
    bytes_accessed: float
    collectives: list
    chip: ChipSpec = field(default_factory=lambda: H100)
    convert_overhead: float = 0.0     # no counterpart in a torch trace
    opaque: dict = field(default_factory=dict)   # kernel -> launches

    @property
    def compute_s(self):
        return self.flops / self.chip.peak_bf16_flops

    @property
    def memory_s(self):
        return self.bytes_accessed / self.chip.hbm_bw

    @property
    def memory_corrected_s(self):
        """Memory term minus the CPU-only f32-promotion traffic (none in a
        torch trace: equal to ``memory_s``)."""
        return max(0.0, self.bytes_accessed - self.convert_overhead) \
            / self.chip.hbm_bw

    @property
    def ici_wire_bytes(self):
        return sum(c.wire_bytes for c in self.collectives if not c.crosses_pod)

    @property
    def dcn_wire_bytes(self):
        return sum(c.wire_bytes for c in self.collectives if c.crosses_pod)

    @property
    def collective_s(self):
        return (self.ici_wire_bytes / self.chip.ici_link_bw
                + self.dcn_wire_bytes / self.chip.dcn_bw)

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self):
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_time_s(self):
        """No-overlap upper bound."""
        return self.compute_s + self.memory_s + self.collective_s

    def extrapolate(self, rep2, repeats: int):
        """Linear depth extrapolation: self is the R=1 trace, rep2 the R=2
        trace; returns the R=repeats estimate. Collectives are diffed as a
        multiset — the per-layer body collectives appear (repeats-1) extra
        times. Opaque kernel launches extrapolate like the FLOPs."""
        from collections import Counter

        def key(c):
            return (c.kind, c.payload_bytes, c.group_size, c.crosses_pod,
                    c.wire_bytes)

        c1 = Counter(key(c) for c in self.collectives)
        c2 = Counter(key(c) for c in rep2.collectives)
        body = c2 - c1
        colls = list(self.collectives)
        for (kind, payload, gsize, crosses, wire), cnt in body.items():
            for _ in range(cnt * (repeats - 1)):
                colls.append(CollectiveOp(kind, payload, gsize, crosses, wire))
        opaque = {k: self.opaque.get(k, 0) + (repeats - 1)
                  * (rep2.opaque.get(k, 0) - self.opaque.get(k, 0))
                  for k in set(self.opaque) | set(rep2.opaque)}
        return RooflineReport(
            flops=self.flops + (repeats - 1) * (rep2.flops - self.flops),
            bytes_accessed=self.bytes_accessed
            + (repeats - 1) * (rep2.bytes_accessed - self.bytes_accessed),
            collectives=colls, chip=self.chip,
            convert_overhead=self.convert_overhead + (repeats - 1)
            * (rep2.convert_overhead - self.convert_overhead),
            opaque=opaque)

    def summary(self):
        return {
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "ici_wire_bytes": self.ici_wire_bytes,
            "dcn_wire_bytes": self.dcn_wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_corrected_s": self.memory_corrected_s,
            "convert_overhead_bytes": self.convert_overhead,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "n_collectives": len(self.collectives),
            "opaque": dict(self.opaque),
        }


def roofline_from_trace(fn, args, mesh=None, chip: ChipSpec = H100):
    """Run ``fn(*args)`` under ``core.op_count.op_count`` and return its
    per-device :class:`RooflineReport`: FLOPs and bytes of the whole
    program divided by the mesh's ranks, the collectives the mesh's
    recorder logged (a mesh with a ``"pod"`` axis charges them across
    pods). A hand-written kernel the step launches is named in
    ``opaque`` with its launches, and counts nothing."""
    from repro_torch.core.op_count import op_count
    with op_count() as count:
        fn(*args)
    return roofline_from_count(count, mesh, chip)


def roofline_from_count(count, mesh=None, chip: ChipSpec = H100):
    """:func:`roofline_from_trace`'s report from an ``OpCount`` already
    taken."""
    n, colls = 1, []
    if mesh is not None:
        n = mesh.n
        per_pod = n // mesh.shape["pod"] if "pod" in mesh.shape else 0
        colls = parse_collectives(count.events, mesh, per_pod)
    return RooflineReport(flops=count.flops / n,
                          bytes_accessed=count.bytes / n, collectives=colls,
                          chip=chip, opaque=count.opaque)
