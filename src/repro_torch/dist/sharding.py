"""Logical-axis rules (the part of ``repro/dist/sharding.py::Rules`` that
the models read).

``Rules`` maps *logical* tensor axes ("batch", "ff", "experts_data", ...)
to the axes of a :class:`~repro_torch.dist.mesh.VirtualMesh`: the n ranks
of one card, stacked on a leading axis. A mesh whose axis is named
``"data"`` (or ``"pod"``) is a data axis: the batch shards over it and,
in ``alltoall`` expert parallelism, so do the experts. An axis named
``"model"`` is a tensor-parallel axis, which the port's models do not run
yet (ROADMAP queue 1, item 5). There are no PartitionSpecs: on one device
a rank's shard is a slice of the stacked layout, cut where a body needs
it (``models/moe.py``).
"""
from __future__ import annotations

DP_AXIS_NAMES = ("pod", "data")
TP_AXIS_NAMES = ("model",)


def _compact(axes):
    """() -> None, 1-tuple -> name, n-tuple -> tuple (PartitionSpec style)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


class Rules:
    def __init__(self, mesh, kind: str = "train"):
        self.mesh = mesh
        self.kind = kind
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
            "seq_kv": None,     # sequence parallelism: not ported yet
        }

    def __repr__(self):
        return f"Rules({self.mesh!r}, kind={self.kind!r})"

    @property
    def dp_axes(self):
        return self._dp

    @property
    def tp_axes(self):
        return self._tp

    def axes(self, name):
        """Mesh axes for a logical axis name (None = replicated)."""
        return self.table.get(name)

    def dp_size(self):
        size = 1
        for a in self._dp:
            size *= int(self.mesh.shape[a])
        return size

    def shard(self, x, *names):
        """The reference's activation sharding constraint. Every rank of a
        ``VirtualMesh`` lives on one device, so a constraint moves nothing:
        the identity."""
        del names
        return x
