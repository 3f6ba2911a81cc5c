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
* **Peak by site** (``op_count(sites=True)``): the most bytes live at
  each allocation site, a site being the op's frames in this package
  inside the count (file and line), and, in a backward pass, the autograd
  node that runs it with the site that made that node in the forward.
  A site names no loop index, so the iterations of a loop share it;
  ``launch/dryrun.py`` scales these per-site peaks in the loops' trip
  counts.
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
import os
import sys
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import mesh as _mesh

aten = torch.ops.aten
_HERE = os.path.abspath(__file__)
_PACKAGE = os.path.dirname(os.path.dirname(_HERE)) + os.sep
_OURS = {}        # a code object's file name -> in this package, not here


def _ours(name):
    """True for a file of this package other than this module (a file
    name as the import made it, relative where ``sys.path`` was)."""
    if name not in _OURS:
        path = os.path.abspath(name)
        _OURS[name] = path.startswith(_PACKAGE) and path != _HERE
    return _OURS[name]

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


def _leaves(x, out):
    """The leaves of an op's arguments or results (tuples, lists and dicts
    of tensors and numbers) into ``out``: ``tree_leaves`` without its
    registry, in the dispatch path of every op."""
    if isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


def _tensors(tree):
    """The distinct tensors of ``tree`` (the same view twice counts once)."""
    seen, out = set(), []
    for t in _leaves(tree, []):
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
    kernel name -> launches; ``site_peaks`` (None unless asked for) site
    -> the most bytes live just after an allocation there."""
    flops: int = 0
    bytes: int = 0
    ops: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0
    events: list = dataclasses.field(default_factory=list)
    opaque: dict = dataclasses.field(default_factory=dict)
    site_peaks: dict | None = None

    def __post_init__(self):
        self._lock = threading.RLock()
        self._live = {}
        self._node_sites = {}
        self._outer = set()      # the frames that entered the count

    def enter(self):
        """Mark the frames on the stack now as outside every site (kept
        alive here, so no later frame takes one's identity)."""
        f = sys._getframe(1)
        while f is not None:
            self._outer.add(f)
            f = f.f_back

    def hold(self, t, site=None):
        """Count the storage of ``t`` live until it dies (made at
        ``site``)."""
        s = t.untyped_storage()
        k = s._cdata
        with self._lock:
            if k in self._live:
                return
            n = s.nbytes()
            self._live[k] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            if self.site_peaks is not None:
                self.site_peaks[site] = max(self.site_peaks.get(site, 0),
                                            self.live_bytes)
        weakref.finalize(s, self._free, k)

    def site(self):
        """The running op's site (see the module's docstring); records it
        as the forward site of the autograd node the op made, if any."""
        frames, f = [], sys._getframe(1)
        while f is not None and f not in self._outer:
            name = f.f_code.co_filename
            if _ours(name):
                frames.append((name, f.f_lineno))
            f = f.f_back
        node = torch._C._current_autograd_node()
        made = None if node is None else (
            node.name(), self._node_sites.get(node._sequence_nr()))
        site = (tuple(frames), made)
        # autograd makes an op's node before the op reaches this mode
        seq = torch._C._autograd._get_sequence_nr() - 1
        if seq >= 0:
            self._node_sites.setdefault(seq, site)
        return site

    def _free(self, k):
        with self._lock:
            self.live_bytes -= self._live.pop(k, 0)

    def append(self, ev):
        """The recorder's sink: keep the event, not its tensors."""
        self.events.append(dataclasses.replace(ev, operand=None,
                                               result=None))


class _Uncached(Exception):
    pass


def _meta_key(x):
    """What a meta op's result depends on: every tensor argument's
    metadata and every other argument's type and value (``2`` and ``2.0``
    promote apart)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Uncached
        return (tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(map(_meta_key, x))
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in x.items())
    return type(x), x


class _Like(tuple):
    """A result tensor's metadata (shape, stride, dtype), not the tensor:
    keeping the tensor would keep its storage alive."""


def _skeleton(out):
    """``out``'s metadata; raises ``_Uncached`` for a tensor that a new
    meta tensor of its shape and strides would not reproduce (one on
    another device, an offset into or a part of a larger storage)."""
    if isinstance(out, torch.Tensor):
        size = 0 if 0 in out.shape else 1 + sum(
            (n - 1) * st for n, st in zip(out.shape, out.stride()))
        if out.device.type != "meta" or out.storage_offset() \
                or out.untyped_storage().nbytes() != size * out.element_size():
            raise _Uncached
        return _Like((tuple(out.shape), out.stride(), out.dtype))
    if isinstance(out, (list, tuple)):
        return type(out)(map(_skeleton, out))
    return out


def _fresh(skel):
    """New meta tensors of the metadata ``_skeleton`` kept."""
    if isinstance(skel, _Like):
        shape, stride, dtype = skel
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    if isinstance(skel, (list, tuple)):
        return type(skel)(map(_fresh, skel))
    return skel


class _Counter(TorchDispatchMode):
    """A meta op that makes new tensors (no view, alias or in-place
    write) gives results that depend on its arguments' metadata only: its
    results are kept by that metadata, and a repeat of it (every
    iteration of a loop over tokens) makes new meta tensors of the same
    metadata instead of running the op's shape function again."""

    def __init__(self, count):
        super().__init__()
        self.count = count
        self._meta = {}
        self._aliasing = set()

    def _run(self, func, args, kwargs):
        schema = func._schema
        if func.is_view or schema.is_mutable or func in self._aliasing or any(
                r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            hash(key)
        except (_Uncached, TypeError):
            return func(*args, **kwargs)
        if key in self._meta:
            return _fresh(self._meta[key])
        out = func(*args, **kwargs)
        own = {_key(t) for t in _tensors((args, kwargs))}
        if any(_key(t) in own for t in _tensors(out)):
            self._aliasing.add(func)     # ``_unsafe_view``: no new storage
            return out
        try:
            self._meta[key] = _skeleton(out)
        except _Uncached:
            pass
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.count
        site = c.site() if c.site_peaks is not None else None
        out = self._run(func, args, kwargs)
        outs = _tensors(out)
        for t in outs:
            c.hold(t, site)
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
def op_count(held=(), sites=False):
    """Count every aten op run inside the context (on this thread and the
    autograd engine's): yields the :class:`OpCount`, complete at exit.
    ``held``: tensors live from the start (a step's arguments), counted
    in the peak; ``sites``: also keep the peak of every site."""
    count = OpCount(site_peaks={} if sites else None)
    count.enter()
    for t in _tensors(held):
        count.hold(t)
    before = _launches()
    with _mesh.record(count), _Counter(count):
        yield count
    count._outer.clear()
    count.opaque = {k: v - before[k] for k, v in _launches().items()
                    if v != before[k]}
