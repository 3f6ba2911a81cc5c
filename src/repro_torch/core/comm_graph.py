"""Static analyzer: host-driven program -> communication dependency graph
(paper §3.2 step 1, Appendix F). Port of ``repro/core/comm_graph.py``.

The reference walks the jaxpr of the host baseline. The port runs the
baseline once instead, under a ``TorchFunctionMode`` that logs every torch
call (the compute "equations") and under the virtual mesh's recorder,
which logs every collective with its per-rank operand shape and bytes.
Tensor identity links producers to consumers, so each collective learns
which ops fed it and which consumed its result — the data the fast path
needs to pick transformation targets.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.dist import mesh as vmesh


@dataclass
class CommNode:
    index: int                    # global op order
    prim: str                     # collective name (e.g. "all_to_all")
    kind: str                     # HLO-style collective kind
    axes: tuple                   # mesh axes the collective runs over
    operands: list                # [(shape, dtype, bytes)] per rank
    producers: list = field(default_factory=list)   # producing op names
    consumers: list = field(default_factory=list)   # consuming op names

    @property
    def payload_bytes(self):
        return sum(b for _, _, b in self.operands)

    def describe(self):
        shapes = ", ".join(f"{d}[{','.join(map(str, s))}]"
                           for s, d, _ in self.operands)
        return (f"#{self.index:<4d} {self.kind:20s} axes={self.axes} "
                f"({shapes})\n        produced by: {self.producers}"
                f"\n        consumed by: {self.consumers}")


@dataclass
class CommGraph:
    nodes: list
    n_eqns: int
    order: list                   # [(index, 'compute'|'communicate', prim)]

    @property
    def collective_bytes(self):
        return sum(n.payload_bytes for n in self.nodes)

    def phases(self):
        """Collapse consecutive compute ops: [('compute', n), ('comm', node)]."""
        out = []
        run = 0
        for _idx, kind, prim in self.order:
            if kind == "compute":
                run += 1
            else:
                if run:
                    out.append(("compute", run))
                    run = 0
                out.append(("communicate", prim))
        if run:
            out.append(("compute", run))
        return out

    def describe(self):
        lines = [f"Communication Graph ({len(self.nodes)} collectives, "
                 f"{self.n_eqns} ops)"]
        for n in self.nodes:
            lines.append("  " + n.describe())
        lines.append("Execution Order (phases)")
        for kind, x in self.phases():
            lines.append(f"  {kind}: {x}")
        return "\n".join(lines)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class _Tracer(TorchFunctionMode):
    """Logs torch calls and collectives in program order. ``producer`` maps
    a live tensor's id to (op name, CommNode or None); ``_keep`` holds every
    logged tensor so that no id is reused while the tracer runs."""

    def __init__(self):
        super().__init__()
        self.nodes, self.order, self.producer, self._keep = [], [], {}, []

    def _produced(self, tensors, name, node):
        for t in tensors:
            self.producer[id(t)] = (name, node)
            self._keep.append(t)

    def _consume(self, tensors, name):
        srcs = set()
        for t in tensors:
            got = self.producer.get(id(t))
            if got is None:
                continue
            prim, node = got
            srcs.add(prim)
            if node is not None and name not in node.consumers:
                node.consumers.append(name)
        return srcs

    def append(self, ev):             # the mesh recorder's sink
        idx = len(self.order)
        prim = ev.kind.replace("-", "_")
        axes = ev.axis if isinstance(ev.axis, tuple) else (ev.axis,)
        node = CommNode(index=idx, prim=prim, kind=ev.kind, axes=axes,
                        operands=[(ev.shape, ev.dtype, ev.payload_bytes)])
        node.producers = sorted(self._consume([ev.operand], prim))
        self.nodes.append(node)
        self.order.append((idx, "communicate", prim))
        self._produced([ev.result], prim, node)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        products = list(_tensors(out))
        if vmesh.in_collective() or not products:
            return out                # a collective's body, or metadata
        name = getattr(func, "__name__", str(func))
        self._consume(_tensors((args, kwargs)), name)
        self.order.append((len(self.order), "compute", name))
        self._produced(products, name, None)
        return out


def analyze(fn, *example_args) -> CommGraph:
    """Build the communication dependency graph of ``fn`` by running it
    once on ``example_args``."""
    tracer = _Tracer()
    with torch.no_grad(), vmesh.record(tracer), tracer:
        fn(*example_args)
    return CommGraph(nodes=tracer.nodes, n_eqns=len(tracer.order),
                     order=tracer.order)
