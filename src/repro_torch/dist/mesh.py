"""The virtual mesh: ``n`` ranks on one device as a leading rank axis.

Port of ``launch/mesh.py`` plus the collectives the host builds use
(``jax.lax.all_to_all``, ``jax.lax.all_gather`` and ``jax.lax.ppermute``
under ``shard_map``). Every per-rank tensor is stacked on axis 0
(``(n, ...)``, the JAX package's global layout), so a collective is an
exact permutation (or, for ``all_gather``, a broadcast) of that axis.
The host baseline and the STREAM_SPLIT / TokenWeave builds run through
it; the device-initiated kernels address the ranks' slabs directly and
do not.

A recorder (:func:`record`) logs each collective's kind and per-rank
payload bytes — what ``core/comm_graph.py`` reads instead of a jaxpr.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch

# active recorders; one per ``record()`` context, innermost last
_RECORDERS = []
# per-thread depth of collectives being run (see in_collective)
_STATE = threading.local()


@dataclass(frozen=True)
class CollectiveEvent:
    kind: str                     # HLO-style collective kind
    axis: str
    shape: tuple                  # per-rank operand shape
    dtype: str
    payload_bytes: int            # per-rank operand bytes
    operand: object = field(default=None, repr=False, compare=False)
    result: object = field(default=None, repr=False, compare=False)


@contextlib.contextmanager
def record(sink=None):
    """Collect every collective any :class:`VirtualMesh` runs inside the
    context, in issue order, into ``sink`` (anything with ``append``; a
    new list by default), which the context yields."""
    events = [] if sink is None else sink
    _RECORDERS.append(events)
    try:
        yield events
    finally:
        _RECORDERS.remove(events)


def in_collective() -> int:
    """How many collectives this thread is inside (0 outside any): the
    tensor ops that implement a collective are not compute of the program
    a recorder is analysing."""
    return getattr(_STATE, "depth", 0)


@contextlib.contextmanager
def _inside():
    _STATE.depth = in_collective() + 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def _log(kind, axis, operand, result):
    ev = CollectiveEvent(kind=kind, axis=axis, shape=tuple(operand.shape[1:]),
                         dtype=str(operand.dtype).replace("torch.", ""),
                         payload_bytes=operand[0].numel()
                         * operand.element_size(),
                         operand=operand, result=result)
    for rec in _RECORDERS:
        rec.append(ev)


class VirtualMesh:
    """``n`` ranks of one mesh axis living on one device.

    ``device`` defaults to ``"cuda"``; the tests pass ``"cpu"``."""

    def __init__(self, n, device="cuda", axis="x"):
        if n < 1:
            raise ValueError(f"a mesh needs at least one rank, got n={n}")
        self.n = int(n)
        self.device = torch.device(device)
        self.axis = axis
        self.axis_names = (axis,)
        self.shape = {axis: self.n}

    def __repr__(self):
        return f"VirtualMesh(n={self.n}, device={self.device}, axis={self.axis!r})"

    def _check(self, t):
        if t.shape[0] != self.n or t.shape[1] != self.n:
            raise ValueError(f"all_to_all wants (n, n, ...) with n={self.n}, "
                             f"got {tuple(t.shape)}")

    def all_to_all(self, t):
        """``t[r, e]`` is what rank ``r`` sends to rank ``e``; the result's
        ``[e, r]`` is what rank ``e`` received from ``r`` (the tiled
        ``jax.lax.all_to_all`` over axis 0 of each rank's block)."""
        self._check(t)
        with _inside():
            out = t.transpose(0, 1).contiguous()
            _log("all-to-all", self.axis, t, out)
        return out

    def all_gather(self, t, tiled=True):
        """``jax.lax.all_gather`` over the rank axis: every rank gets every
        rank's block. ``t`` (n, rows, ...) gives (n, n*rows, ...) with
        ``tiled`` (the blocks concatenated) and (n, n, rows, ...) without
        (the blocks stacked)."""
        if t.dim() < 2 or t.shape[0] != self.n:
            raise ValueError(f"all_gather wants (n, rows, ...) with "
                             f"n={self.n}, got {tuple(t.shape)}")
        with _inside():
            blocks = t.reshape(-1, *t.shape[2:]) if tiled else t
            out = blocks[None].expand(self.n, *blocks.shape).contiguous()
            _log("all-gather", self.axis, t, out)
        return out

    def ppermute(self, t, pairs):
        """``jax.lax.ppermute`` over the rank axis: ``out[dst] = t[src]``
        for each ``(src, dst)`` pair; a rank no pair targets gets zeros."""
        if t.shape[0] != self.n:
            raise ValueError(f"ppermute wants (n, ...) with n={self.n}, "
                             f"got {tuple(t.shape)}")
        pairs = [(int(s), int(d)) for s, d in pairs]
        srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) \
                or not all(0 <= r < self.n for r in srcs + dsts):
            raise ValueError(f"ppermute pairs {pairs} are not a partial "
                             f"permutation of {self.n} ranks")
        with _inside():
            out = torch.zeros_like(t)
            if pairs:
                out[dsts] = t[srcs]
            _log("collective-permute", self.axis, t, out)
        return out
