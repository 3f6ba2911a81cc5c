"""The virtual mesh: the ranks of a mesh on one device, stacked on a
leading rank axis.

Port of ``launch/mesh.py``'s meshes plus the collectives the host builds
and the sharded models use (``jax.lax.psum``, ``jax.lax.all_to_all``,
``jax.lax.all_gather``, ``jax.lax.ppermute`` and ``jax.lax.axis_index``
under ``shard_map``). A mesh has one or more named axes; its ranks are
stacked on axis 0 of every per-rank tensor (``(n, ...)``, n the product
of the axis sizes) in row-major order of the axes, the order in which
``jax.make_mesh`` lays out devices: on a ``("data", "model")`` mesh of
shape (2, 2), rank ``2 * d + m`` has data coordinate d and model
coordinate m. A collective over some axes acts within each group of
ranks that differ only in those axes, so it is an exact permutation,
gather or sum along the rank axis. The host baseline and the
STREAM_SPLIT / TokenWeave builds run through it; the device-initiated
kernels address the ranks' slabs directly and do not.

A recorder (:func:`record`) logs each collective's kind and per-rank
payload bytes — what ``core/comm_graph.py`` reads instead of a jaxpr.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

# active recorders; one per ``record()`` context, innermost last
_RECORDERS = []
# per-thread depth of collectives being run (see in_collective)
_STATE = threading.local()


@dataclass(frozen=True)
class CollectiveEvent:
    kind: str                     # HLO-style collective kind
    axis: object                  # the axis name, or a tuple of several
    shape: tuple                  # per-rank operand shape
    dtype: str
    payload_bytes: int            # per-rank operand bytes
    result_bytes: int = 0         # per-rank result bytes
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
                         result_bytes=result[0].numel()
                         * result.element_size(),
                         operand=operand, result=result)
    for rec in _RECORDERS:
        rec.append(ev)


class VirtualMesh:
    """The ranks of a mesh living on one device.

    ``VirtualMesh(n, device=, axis=)`` has one axis of ``n`` ranks named
    ``axis``; ``VirtualMesh((2, 2), axes=("data", "model"), device=)``
    has one axis a name, of the given sizes. ``axis_names`` and ``shape``
    (name -> size) read as the reference mesh's. ``device`` defaults to
    ``"cuda"``; the tests pass ``"cpu"``.

    A collective names the axes it runs over (``psum``: any of them;
    ``all_to_all``, ``all_gather`` and ``ppermute``: one axis, or a
    tuple of axes taken as one in row-major order, as ``jax.lax`` takes
    them); on a one-axis mesh they default to its axis."""

    def __init__(self, shape, device="cuda", axis="x", axes=None):
        dims = (shape,) if isinstance(shape, int) else tuple(shape)
        axes = (axis,) if axes is None and len(dims) == 1 else axes
        if axes is None or len(axes) != len(dims) or len(set(axes)) != \
                len(axes):
            raise ValueError(f"a mesh of shape {dims} wants one distinct "
                             f"axis name a dimension, got {axes}")
        if not dims or min(dims) < 1:
            raise ValueError(f"a mesh needs at least one rank, got n={dims}")
        self.dims = tuple(int(s) for s in dims)
        self.n = math.prod(self.dims)
        self.device = torch.device(device)
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, self.dims))
        # the one-axis mesh's axis (the default of every collective)
        self.axis = self.axis_names[0] if len(self.dims) == 1 else None
        self._coords = np.stack(np.unravel_index(np.arange(self.n),
                                                 self.dims), 1)
        self._cache = {}

    def __repr__(self):
        if self.axis is not None:
            return (f"VirtualMesh(n={self.n}, device={self.device}, "
                    f"axis={self.axis!r})")
        return (f"VirtualMesh({self.dims}, axes={self.axis_names}, "
                f"device={self.device})")

    def _group(self, axes):
        """``axes`` (None: the one-axis mesh's axis; a name; a tuple) as a
        tuple of names of this mesh."""
        if axes is None:
            if self.axis is None:
                raise ValueError(f"{self} has several axes: name the one a "
                                 "collective runs over")
            axes = self.axis
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"{self} has no axis {unknown}")
        return axes

    def _index(self, axes):
        """numpy (n,): each rank's coordinate over ``axes`` (row-major)."""
        dims = [self.dims[self.axis_names.index(a)] for a in axes]
        cols = [self._coords[:, self.axis_names.index(a)] for a in axes]
        return (np.ravel_multi_index(cols, dims) if axes
                else np.zeros(self.n, dtype=np.int64))

    def _partners_np(self, axes):
        """numpy (n, k): rank ``r``'s partner at coordinate ``j`` of
        ``axes`` — the rank whose other coordinates are ``r``'s."""
        key = ("partners_np", axes)
        if key not in self._cache:
            if not axes:
                self._cache[key] = np.arange(self.n)[:, None]
                return self._cache[key]
            at = [self.axis_names.index(a) for a in axes]
            sub = [self.dims[i] for i in at]
            inner = np.stack(np.unravel_index(np.arange(math.prod(sub)),
                                              sub), 1)
            coords = np.repeat(self._coords[:, None], len(inner), 1)
            coords[:, :, at] = inner[None]
            self._cache[key] = np.ravel_multi_index(
                tuple(np.moveaxis(coords, 2, 0)), self.dims)
        return self._cache[key]

    def _partners(self, axes):
        key = ("partners", axes)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self._partners_np(axes),
                                               device=self.device)
        return self._cache[key]

    def axis_index(self, axes=None):
        """``jax.lax.axis_index`` on every rank at once: an (n,) long
        tensor of each rank's coordinate over ``axes`` (a tuple of names:
        their coordinates in row-major order, 0 for no axes)."""
        axes = self._group(axes)
        key = ("index", axes)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self._index(axes),
                                               device=self.device)
        return self._cache[key]

    def size(self, axes=None):
        """The number of ranks in one group over ``axes``."""
        axes = self._group(axes)
        return math.prod(self.shape[a] for a in axes)

    def spans(self, axes):
        """True when a rank's coordinate over ``axes`` is the rank itself:
        the axes are the mesh's every axis of more than one rank, in the
        mesh's order (so a per-coordinate tensor is already per rank)."""
        axes = self._group(axes)
        return self.size(axes) == self.n and list(axes) == [
            a for a in self.axis_names if a in axes]

    def group(self, axes, rank=0):
        """The ranks that differ from ``rank`` only in ``axes``, in the
        order of their coordinate over ``axes``."""
        return self._partners_np(self._group(axes))[rank].tolist()

    def _check_ranks(self, t, op, want="(n, ...)"):
        if t.dim() < 1 or t.shape[0] != self.n:
            raise ValueError(f"{op} wants {want} with n={self.n}, got "
                             f"{tuple(t.shape)}")

    def _tag(self, axes):
        return axes[0] if len(axes) == 1 else axes

    def psum(self, t, axes=None):
        """``jax.lax.psum`` over ``axes``: each rank gets the sum of ``t``
        over the ranks that differ from it only in ``axes``. No axes: the
        identity, as in ``jax.lax``."""
        axes = self._group(axes)
        if not axes:
            return t
        self._check_ranks(t, "psum")
        with _inside():
            out = t[self._partners(axes)].sum(dim=1)
            _log("all-reduce", self._tag(axes), t, out)
        return out

    def all_to_all(self, t, axis=None):
        """``t[r, j]`` is what rank ``r`` sends to its partner at coordinate
        ``j`` of ``axis``; the result's ``[r, i]`` is what rank ``r``
        received from its partner at ``i`` (the tiled ``jax.lax.all_to_all``
        over axis 0 of each rank's block). On a one-axis mesh ``t`` is
        (n, n, ...) and the result is ``t`` transposed in its first two
        axes."""
        axes = self._group(axis)
        k = self.size(axes)
        if t.dim() < 2 or t.shape[0] != self.n or t.shape[1] != k:
            raise ValueError(f"all_to_all wants (n, {k}, ...) with n="
                             f"{self.n}, got {tuple(t.shape)}")
        with _inside():
            out = t[self._partners(axes), self.axis_index(axes)[:, None]]
            _log("all-to-all", self._tag(axes), t, out)
        return out

    def all_gather(self, t, tiled=True, axis=None):
        """``jax.lax.all_gather`` over ``axis``: every rank gets the blocks
        of its k partners over the axis. ``t`` (n, rows, ...) gives (n,
        k*rows, ...) with ``tiled`` (the blocks concatenated) and (n, k,
        rows, ...) without (the blocks stacked)."""
        axes = self._group(axis)
        if t.dim() < 2 or t.shape[0] != self.n:
            raise ValueError(f"all_gather wants (n, rows, ...) with "
                             f"n={self.n}, got {tuple(t.shape)}")
        with _inside():
            out = t[self._partners(axes)]
            if tiled:
                out = out.reshape(self.n, -1, *t.shape[2:])
            _log("all-gather", self._tag(axes), t, out)
        return out

    def ppermute(self, t, pairs, axis=None):
        """``jax.lax.ppermute`` over ``axis``: for each ``(src, dst)`` pair
        of coordinates, the rank at ``dst`` gets its partner at ``src``'s
        ``t``; a rank no pair targets gets zeros."""
        axes = self._group(axis)
        k = self.size(axes)
        self._check_ranks(t, "ppermute")
        pairs = [(int(s), int(d)) for s, d in pairs]
        srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) \
                or not all(0 <= r < k for r in srcs + dsts):
            raise ValueError(f"ppermute pairs {pairs} are not a partial "
                             f"permutation of {k} ranks")
        with _inside():
            out = torch.zeros_like(t)
            if pairs:
                src_of = np.full(k, -1)
                src_of[dsts] = srcs
                want = src_of[self._index(axes)]
                ranks = np.nonzero(want >= 0)[0]
                out[ranks.tolist()] = t[self._partners_np(axes)[
                    ranks, want[ranks]].tolist()]
            _log("collective-permute", self._tag(axes), t, out)
        return out
