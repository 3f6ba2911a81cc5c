"""The auditable l3 cost breakdown: ordered segments whose sum IS the
analytic cost a workload's ``cost_breakdown`` models.

Port copy of the breakdown half of ``repro/core/cost_model.py``
(``CostSegment``, ``CostBreakdown``, ``per_tile_exposed_s``,
``window_stall_factor``). The HLO-text parsers of the reference
(``parse_collectives``, ``roofline_from_compiled``) read XLA output and
have no counterpart here yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

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
