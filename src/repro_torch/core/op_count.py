"""The count of a step that the roofline reads: FLOPs, bytes accessed,
peak live bytes and the collectives, taken while the step runs.

The reference reads a compiled XLA module (``cost_analysis()`` and the HLO
text). The port has no compiled module; it counts the torch program itself
as it runs, on meta tensors (no data, any size) or on the card, through a
``TorchDispatchMode`` that sees every aten op:

* **FLOPs**: ``torch.utils.flop_counter``'s per-op formulas (mm, addmm,
  bmm, baddbmm, convolution, SDPA). Every other op counts none, as
  XLA's ``cost_analysis`` charges the dots.
* **Bytes accessed**: each op's distinct inputs plus its outputs, each
  read or written once, a broadcast (stride-0) dim once, a scalar (0-d)
  not at all: a Python number becomes a tensor by other ops on other
  devices (``lift_fresh`` on the host, ``scalar_tensor`` on meta), and a
  kernel takes it as an argument. Views, aliases and metadata-only ops
  move nothing; an in-place op reads its operands
  and writes its output once, and one that overwrites its output
  (``copy_``, ``fill_``, ``zero_``) does not read it first.
* **Peak live bytes**: each storage an op creates adds its size and a
  finalizer takes it off when the storage dies; ``held`` tensors (a
  step's arguments) are live from the start.
* **Collectives**: the ``VirtualMesh`` collectives the program runs, from
  ``dist.mesh.record`` in the same pass. The tensor ops that implement
  one (``dist.mesh.in_collective``) are not compute of the program: they
  are left out of the FLOPs and the bytes, which the wire term covers.
  The storage a collective's result takes is memory all the same, and
  stays in the peak.
* **Hand-written kernels are opaque**: a wrapper launches its kernel
  through ``ctypes``, which no aten op shows. ``opaque`` names every
  kernel whose ``LAUNCHES`` counter moved in the pass, with its launches;
  nothing is guessed for them.

The backward of a collective is autograd's gather or scatter-add over the
stacked ranks; the recorder does not log it, and it is counted as compute
traffic.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import mesh as _mesh

aten = torch.ops.aten

KERNELS = ("moe_dispatch", "kv_shuttle", "gemm_allgather", "flash_attention",
           "ring_attention")

# ops that move no bytes: aliases and allocations that write nothing
_NO_TRAFFIC = {aten.detach.default, aten.alias.default,
               aten.lift_fresh.default, aten.empty.memory_format,
               aten.empty_like.default, aten.empty_strided.default,
               aten.new_empty.default, aten.new_empty_strided.default,
               aten._unsafe_view.default}
# in-place ops that overwrite their first argument without reading it
_OVERWRITE = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
              aten.zero_.default}


def _key(t):
    return t.untyped_storage()._cdata


def _bytes(t):
    """Bytes of ``t`` read or written once: a stride-0 dim counts once, a
    0-d tensor (a scalar, which a kernel takes as an argument) nothing."""
    if t.dim() == 0 or t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    """The distinct tensors of ``tree`` (the same view twice counts once)."""
    seen, out = set(), []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            k = (_key(t), t.storage_offset(), tuple(t.shape), t.stride(),
                 t.dtype)
            if k not in seen:
                seen.add(k)
                out.append(t)
    return out


def storage_bytes(tree):
    """Bytes of the distinct storages behind the tensors of ``tree``."""
    return sum({_key(t): t.untyped_storage().nbytes()
                for t in _tensors(tree)}.values())


@dataclasses.dataclass
class OpCount:
    """What one pass counted. ``flops`` and ``bytes`` are the whole
    program's (every rank of a ``VirtualMesh`` together); ``peak_bytes``
    the most bytes live at once, ``held`` included; ``events`` the
    recorder's ``CollectiveEvent`` (without their tensors); ``opaque``
    kernel name -> launches."""
    flops: int = 0
    bytes: int = 0
    ops: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0
    events: list = dataclasses.field(default_factory=list)
    opaque: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.RLock()
        self._live = {}

    def hold(self, t):
        """Count the storage of ``t`` live until it dies."""
        s = t.untyped_storage()
        k = s._cdata
        with self._lock:
            if k in self._live:
                return
            n = s.nbytes()
            self._live[k] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, k)

    def _free(self, k):
        with self._lock:
            self.live_bytes -= self._live.pop(k, 0)

    def append(self, ev):
        """The recorder's sink: keep the event, not its tensors."""
        self.events.append(dataclasses.replace(ev, operand=None,
                                               result=None))


class _Counter(TorchDispatchMode):
    def __init__(self, count):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.count
        outs = _tensors(out)
        for t in outs:
            c.hold(t)
        if _mesh.in_collective():
            return out
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        moved = 0
        if not (func.is_view or func in _NO_TRAFFIC):
            ins = _tensors((args, kwargs))
            if func._schema.is_mutable:
                if func in _OVERWRITE:
                    ins = ins[1:]
                moved = sum(map(_bytes, ins)) + sum(map(_bytes, outs))
            else:
                own = {_key(t) for t in ins}
                new = [t for t in outs if _key(t) not in own]
                if new or not outs:
                    moved = sum(map(_bytes, ins)) + sum(map(_bytes, new))
        with c._lock:
            c.ops += 1
            c.flops += int(flops)
            c.bytes += moved
        return out


def _launches():
    import importlib
    return {name: sum(importlib.import_module(
        f"repro_torch.kernels.{name}").LAUNCHES.values())
        for name in KERNELS}


@contextlib.contextmanager
def op_count(held=()):
    """Count every aten op run inside the context (on this thread and the
    autograd engine's): yields the :class:`OpCount`, complete at exit.
    ``held``: tensors live from the start (a step's arguments), counted
    in the peak."""
    count = OpCount()
    for t in _tensors(held):
        count.hold(t)
    before = _launches()
    with _mesh.record(count), _Counter(count):
        yield count
    count.opaque = {k: v - before[k] for k, v in _launches().items()
                    if v != before[k]}
