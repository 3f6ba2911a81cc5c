"""Logical-axis sharding rules (port of ``repro/dist/sharding.py``).

``Rules`` maps *logical* tensor axes ("batch", "heads", "ff", "vocab",
"experts_data", ...) to the axes of a
:class:`~repro_torch.dist.mesh.VirtualMesh` per execution kind (train /
prefill / decode). Model code never names mesh axes directly: it asks
``rules.axes("ff")`` for a spec entry or ``rules.param_spec(shape, ...)``
for a divisibility-checked parameter spec.

Conventions (single pod: ("data", "model"); multi-pod adds a leading
"pod" axis that behaves as extra data parallelism):

  batch         -> data (+pod)       activations' leading dim
  heads/kv_heads/ff/vocab -> model   Megatron-style tensor parallelism
  experts_data  -> data              expert-parallel all-to-all mode
  experts_model -> model             expert-sharded replicated mode
  seq_act/seq_res -> model           sequence-parallel activation shards
  seq_kv        -> model iff long_context (500k-token cells) else unsharded
  zero          -> (pod, data)       ZeRO-style optimizer-state sharding

There is no ``PartitionSpec``: a spec is a :class:`P`, a tuple whose
entries are None (replicated), a mesh axis name or a tuple of names, so
it compares equal, entry by entry, to the reference's. Every rank of a
``VirtualMesh`` lives on one device, so a spec places nothing: a body
that runs per rank cuts each rank's shard with :func:`local_shards`, and
``Rules.shard`` (the reference's activation constraint) is the identity.
"""
from __future__ import annotations

import math

DP_AXIS_NAMES = ("pod", "data")
TP_AXIS_NAMES = ("model",)


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``.
    Entries read as ``PartitionSpec``'s do: an empty tuple is None and a
    tuple of one name is the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            _compact(e) if isinstance(e, (tuple, list)) else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _flatten(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _compact(axes):
    """() -> None, 1-tuple -> name, n-tuple -> tuple (PartitionSpec style)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (a :class:`P` is a leaf),
    with the matching leaves of the ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts, in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class Rules:
    def __init__(self, mesh, kind: str = "train", *, long_context=False):
        self.mesh = mesh
        self.kind = kind
        self.long_context = long_context
        names = tuple(mesh.axis_names) if mesh is not None else ()
        self._dp = tuple(a for a in names if a in DP_AXIS_NAMES)
        self._tp = tuple(a for a in names if a in TP_AXIS_NAMES)
        dp, tp = _compact(self._dp), _compact(self._tp)
        self.table = {
            "batch": dp,
            "zero": self._dp,
            "heads": tp,
            "kv_heads": tp,
            "ff": tp,
            "vocab": tp,
            "experts_data": dp,
            "experts_model": tp,
            "seq_act": tp,
            "seq_res": tp,
            "seq_kv": tp if long_context else None,
        }

    def __repr__(self):
        return f"Rules({self.mesh!r}, kind={self.kind!r})"

    # ------------------------------------------------------------- queries
    @property
    def dp_axes(self):
        return self._dp

    @property
    def tp_axes(self):
        return self._tp

    def axes(self, name):
        """Mesh axes for a logical axis name (None = replicated)."""
        return self.table.get(name)

    def _axis_size(self, entry):
        size = 1
        for a in _flatten(entry):
            size *= int(self.mesh.shape[a])
        return size

    def size(self, name):
        return self._axis_size(self.axes(name))

    def dp_size(self):
        return self._axis_size(self._dp)

    # -------------------------------------------------------------- specs
    def _fit(self, entry, dim):
        """Keep a spec entry only if the dim divides over it evenly."""
        if entry is None:
            return None
        size = self._axis_size(entry)
        return entry if size and dim % size == 0 else None

    def param_spec(self, shape, *names):
        """Divisibility-checked spec for a concrete shape. Entries are
        logical axis names or None (replicated dim)."""
        entries = []
        for dim, nm in zip(shape, names):
            ax = self.axes(nm) if isinstance(nm, str) else nm
            entries.append(self._fit(ax, dim))
        return P(*entries)

    def shard(self, x, *names):
        """The reference's activation sharding constraint. Every rank of a
        ``VirtualMesh`` lives on one device, so a constraint moves nothing:
        the identity."""
        del names
        return x


def zero_spec(spec, shape, rules: Rules):
    """ZeRO-style optimizer-state spec: additionally shard the first
    replicated, evenly-divisible dim over the data axes. A spec that
    already uses any data axis is returned unchanged."""
    dp_axes = tuple(rules.table.get("zero") or rules._dp)
    if not dp_axes:
        return spec
    used = {a for entry in spec for a in _flatten(entry)}
    if used & set(dp_axes):
        return spec
    dp = 1
    for a in dp_axes:
        dp *= int(rules.mesh.shape[a])
    if dp <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, e in enumerate(entries):
        if e is None and shape[i] % dp == 0:
            entries[i] = _compact(dp_axes)
            return P(*entries)
    return spec


def sanitize_specs(specs, sds, mesh):
    """Drop spec entries that reference unknown mesh axes or that do not
    divide the corresponding dim evenly (strict-divisible shardings only).
    ``sds``: a tree of the same nesting whose leaves have ``.shape``
    (tensors, or ``cache_specs``' shape records)."""
    sizes = {a: int(s) for a, s in dict(mesh.shape).items()}

    def fix(spec, s):
        shape = s.shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, e in zip(shape, entries):
            axes = _flatten(e)
            size = 1
            known = all(a in sizes for a in axes)
            for a in axes:
                size *= sizes.get(a, 1)
            out.append(e if axes and known and dim % size == 0 else None)
        return P(*out)

    return tree_map(fix, specs, sds)


def _cut(spec, ndim, mesh):
    """Which dims ``spec`` shards on ``mesh``: ``[(dim, axes)]`` for each
    entry whose axes hold more than one rank."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return [(i, _flatten(e)) for i, e in enumerate(entries)
            if mesh.size(_flatten(e)) > 1]


def replicated(spec, mesh):
    """True where ``spec`` shards no dim on ``mesh``: every rank holds the
    whole tensor."""
    return not _cut(spec, len(spec), mesh)


def local_shards(t, spec, mesh):
    """Every rank's shard of the whole tensor ``t`` under ``spec``, stacked
    on the rank axis: (n, *local shape), rank ``r``'s block of each dim
    that ``spec`` shards being the one at ``r``'s coordinate over that
    entry's axes (``jax.lax.axis_index`` of them). A dim that does not
    divide over its axes raises, as ``shard_map`` refuses it. Replicated
    everywhere: a broadcast view, nothing copied. :func:`from_shards` is
    its inverse; the two are the only code that knows which rank holds
    which block."""
    cut = dict(_cut(spec, t.dim(), mesh))
    shape, lead = [], []
    for i, dim in enumerate(t.shape):
        if i in cut:
            k = mesh.size(cut[i])
            if dim % k:
                raise ValueError(f"a dim of {dim} does not shard over "
                                 f"{cut[i]} ({k} ranks) of {mesh}")
            lead.append(len(shape))
            shape += [k, dim // k]
        else:
            shape.append(dim)
    v = t.reshape(shape)
    if not cut:
        return v[None].expand(mesh.n, *shape)
    if list(cut) == [0] and mesh.spans(cut[0]):
        return v                      # one shard a rank, in rank order
    rest = [i for i in range(len(shape)) if i not in lead]
    v = v.permute(*lead, *rest)
    return v[tuple(mesh.axis_index(axes) for axes in cut.values())]


def from_shards(t, spec, mesh):
    """The whole tensor from every rank's shard ``t`` (n, *local shape)
    under ``spec``: the inverse of :func:`local_shards`. Of the ranks that
    hold the same block, the one at coordinate 0 of every axis ``spec``
    does not name is read."""
    local = t.shape[1:]
    cut = dict(_cut(spec, len(local), mesh))
    if not cut:
        return t[0]
    whole = [d * mesh.size(cut[i]) if i in cut else d
             for i, d in enumerate(local)]
    if list(cut) == [0] and mesh.spans(cut[0]):
        return t.reshape(whole)
    blocks = t[mesh.group(tuple(a for ax in cut.values() for a in ax))]
    blocks = blocks.reshape(*(mesh.size(ax) for ax in cut.values()), *local)
    at = {i: p for p, i in enumerate(cut)}        # a block axis a cut dim
    order = [j for i in range(len(local))
             for j in ((at[i], len(cut) + i) if i in at else (len(cut) + i,))]
    return blocks.permute(order).reshape(whole)
