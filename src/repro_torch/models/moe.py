"""Mixture-of-Experts layer with expert parallelism (port of
``repro/models/moe.py``).

Execution modes, as in the reference:

* ``local`` (``rules=None``): full experts on one device; also the oracle
  of the sharded bodies where no token is dropped.
* ``alltoall`` (a :class:`~repro_torch.dist.sharding.Rules` over a data
  mesh): the batch and the experts shard over the ranks of a
  :class:`~repro_torch.dist.mesh.VirtualMesh`. Every body runs per rank on
  the stacked ``(n, ...)`` layout. ``backend="xla"`` takes
  :func:`_alltoall_body` (dispatch and combine through
  ``VirtualMesh.all_to_all``, with the self/remote split of ``overlap``
  and the int8 wire of ``quantize``), or :func:`_gathered_body` for a
  batch that does not shard (B < dp or B % dp != 0). ``backend="pallas"``
  takes :func:`_pallas_body`: dispatch -> expert FFN -> combine as one
  launch of the hand-written Hopper kernel ``csrc/moe_dispatch.cu``
  (``kernels.moe_dispatch.moe_dispatch_combine``), with the shared expert
  as its second stream under ``overlap``; a batch that does not shard
  takes :func:`_padded_body`, one launch of the same kernel on a padded
  layout that computes what :func:`_gathered_body` computes.
* ``replicated`` (``ep_mode != "alltoall"``, experts over the model axis)
  is not ported: it raises (ROADMAP queue 1, item 5).

Capacity-based static shapes throughout (GShard-style token dropping):
the sharded bodies size capacity from each rank's tokens, ``_local_moe``
from all of them, so where tokens are dropped the two differ, exactly as
the reference's do.

Two divergences from the reference, on purpose:

* The reference quietly takes the XLA bodies when a shape is not eligible
  for its kernel (:func:`pallas_moe_eligible`). With ``backend="pallas"``
  the port never does: a batch that does not shard goes through the
  kernel's padded layout (the reference's gathered body, computed by the
  kernel), and every other shape the kernel cannot take (two experts a
  rank, no data axis, no mesh, tensor parallelism) raises ``ValueError``,
  so the kernel is never silently skipped on the main path. The serving
  engine extends the rule to its elastic path: ``Engine.degrade`` onto a
  width the kernel cannot take raises at the degrade, and the caller
  switches to ``backend="xla"`` in the open.
* Every body computes the routed and the shared expert FFNs in float32
  and rounds their outputs to the activation type: the kernel's
  arithmetic (it takes f32 operands). The reference's XLA bodies compute
  them in the activation type, so in bfloat16 its backends differ by
  bf16 roundings where the port's differ only by the order of f32 sums.
  In float32 the two packages compute the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

F32 = torch.float32


def moe_init(gen, cfg, dtype, device):
    E, d, f = cfg.num_experts_padded, cfg.d_model, cfg.moe_d_ff

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=F32)
        return (w / math.sqrt(fan_in)).to(device=device, dtype=dtype)

    p = {"router": dense_init(gen, d, E, F32, device=device),  # router f32
         "wg": normal((E, d, f), d),
         "wu": normal((E, d, f), d),
         "wd": normal((E, f, d), f)}
    if cfg.shared_expert:
        p["shared"] = mlp_init(gen, d, cfg.moe_d_ff, "swiglu", dtype, device)
    return p


def kernel_weights(p):
    """The kernel's f32 operands of one MoE layer (any leading axes):
    ``w1`` = [wg | wu] (E, d, 2f), ``w2`` = wd (E, f, d) and, with a shared
    expert, ``s1`` = [gate | up] (d, 2fs), ``s2`` = down (fs, d).
    Built once per set of weights by ``models.model.with_kernel_weights``
    (the engine does so itself) and read from ``p["kernel"]`` by
    :func:`_pallas_body`, which never builds them."""
    out = {"w1": torch.cat([p["wg"], p["wu"]], dim=-1).to(F32).contiguous(),
           "w2": p["wd"].to(F32).contiguous()}
    if "shared" in p:
        sh = p["shared"]
        out["s1"] = torch.cat([sh["gate"], sh["up"]], dim=-1).to(
            F32).contiguous()
        out["s2"] = sh["down"].to(F32).contiguous()
    return out


# ------------------------------------------------------------------- routing

def _route(x2, router_w, cfg):
    """x2: (..., T, d) -> gates (..., T, k) f32, idx (..., T, k)."""
    logits = x2.to(F32) @ router_w.to(F32)                  # (..., T, E_pad)
    E_pad = logits.shape[-1]
    if E_pad > cfg.num_experts:                             # mask pad experts
        pad = torch.arange(E_pad, device=logits.device) >= cfg.num_experts
        logits = logits.masked_fill(pad, -math.inf)
    gates, idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    return torch.softmax(gates, dim=-1), idx


def _dispatch_indices(idx, E_pad, C):
    """idx: (..., T, k). Returns flat (..., T*k) expert ids, the slot within
    the expert (over each leading index's tokens), keep."""
    flat_e = idx.reshape(*idx.shape[:-2], -1)
    oh = F.one_hot(flat_e, E_pad)                               # (..., Tk, E)
    pos = ((torch.cumsum(oh, dim=-2) - 1) * oh).sum(dim=-1)    # slot in expert
    return flat_e, pos, pos < C


def _expert_ffn(buf, wg, wu, wd):
    """buf: (E, C, d) x w*: (E, d, f)/(E, f, d) -> (E, C, d) float32.
    SwiGLU, in float32."""
    b = buf.to(F32)
    return (F.silu(b @ wg.to(F32)) * (b @ wu.to(F32))) @ wd.to(F32)


def _shared_ffn(p, x2):
    """The shared expert over x2, in float32, rounded to x2's type."""
    return mlp_apply({k: w.to(F32) for k, w in p["shared"].items()},
                     x2.to(F32), "swiglu").to(x2.dtype)


def _capacity(T, k, E, cap_factor):
    return max(1, int(math.ceil(cap_factor * T * k / E)))


def _quantize_i8(x):
    """int8 wire with per-row f32 scales (the reference's formula)."""
    xf = x.to(F32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), \
        scale


def _tokens(Tk, k, device):
    return torch.arange(Tk, device=device) // k


def _slots(x2, router, cfg, C, E, e0=None):
    """Route each rank's tokens x2 (n, T, d) and lay them out in capacity
    slots: ``buf`` (n, E*C, d) holds expert ``e0 + j``'s slot ``p`` at row
    ``j*C + p``. Returns ``buf`` and what the combine needs: the slot of
    each (token, choice) (E*C where it is not kept here), gates and keep.
    ``e0`` (n,) offsets each rank's expert window (the gathered body:
    rank r holds experts [r*E, (r+1)*E)); without it every rank lays out
    all experts."""
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    gates, idx = _route(x2, router, cfg)
    flat_e, pos, keep = _dispatch_indices(idx, E_pad, C)
    local_e = flat_e if e0 is None else flat_e - e0[:, None]
    keep = keep & (local_e >= 0) & (local_e < E)
    slot = torch.where(keep, local_e * C + pos, E * C)          # (n, Tk)
    return _lay_out(x2, slot, keep, k, E * C), slot, gates, keep


def _lay_out(x2, slot, keep, k, EC):
    """Each rank's kept (token, choice) rows of x2 (n, T, d) at their
    ``slot`` (n, T*k): the (n, EC, d) capacity buffer, zero where nothing
    is kept."""
    n, T, d = x2.shape
    src = x2[:, _tokens(T * k, k, x2.device)] * keep[..., None].to(x2.dtype)
    buf = torch.zeros((n, EC + 1, d), dtype=x2.dtype, device=x2.device)
    buf.scatter_add_(1, slot[..., None].expand(-1, -1, d), src)
    return buf[:, :-1]


def _combine(y_slots, slot, gates, keep, k, dtype):
    """Each (token, choice)'s expert row, gated, summed per token: y_slots
    (n, E*C, d) -> (n, T, d) in ``dtype``."""
    n, EC, d = y_slots.shape
    rows = slot.clamp(max=EC - 1)
    contrib = torch.gather(y_slots.to(dtype), 1,
                           rows[..., None].expand(-1, -1, d))
    contrib = contrib * (gates.reshape(n, -1, 1) * keep[..., None]).to(dtype)
    Tk = slot.shape[1]
    y = torch.zeros((n, Tk // k, d), dtype=dtype, device=y_slots.device)
    return y.index_add_(1, _tokens(Tk, k, y.device), contrib)


# ----------------------------------------------------------- execution paths

def _local_moe(x, p, cfg):
    """Single-device path (also the oracle for the sharded paths)."""
    B, S, d = x.shape
    T = B * S
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    x2 = x.reshape(1, T, d)
    buf, slot, gates, keep = _slots(x2, p["router"], cfg, C, E_pad)
    h = _expert_ffn(buf[0].reshape(E_pad, C, d), p["wg"], p["wu"], p["wd"])
    y = _combine(h.reshape(1, E_pad * C, d), slot, gates, keep, k, x.dtype)
    if cfg.shared_expert:
        y = y + _shared_ffn(p, x2)
    return y.reshape(B, S, d)


def _replicated_body(*args, **kw):
    raise NotImplementedError(
        "the replicated expert-parallel body (ep_mode != 'alltoall': experts "
        "over the model axis, psum combine) is not ported yet (ROADMAP "
        "queue 1, item 5)")


def _alltoall_body(x2, p, cfg, mesh, *, overlap, quantize):
    """Paper-faithful EP per rank on the stacked layout: x2 (n, T, d), rank
    r's tokens in row r; rank e holds experts [e*E_l, (e+1)*E_l). Dispatch
    all-to-all -> expert FFN -> combine all-to-all, through ``mesh``.

    With ``overlap`` the self chunk's FFN is computed from each rank's own
    send buffer (no dependency on the dispatch all-to-all) and the
    received self rows are zero-masked, as in the reference's two-stream
    split. ``quantize`` sends the dispatch as int8 with per-row scales."""
    n, T, d = x2.shape
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    E_l = E_pad // n
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    buf, slot, gates, keep = _slots(x2, p["router"], cfg, C, E_pad)
    buf = buf.reshape(n, n, E_l, C, d)          # [src rank, dst rank, ...]

    def ffn(chunk):
        """chunk (n dst, m src, E_l, C, d): rank e's FFN over the rows it
        holds, its tokens grouped by expert."""
        m = chunk.shape[1]
        cg = chunk.transpose(1, 2).reshape(n * E_l, m * C, d)
        h = _expert_ffn(cg, p["wg"], p["wu"], p["wd"])
        return h.reshape(n, E_l, m, C, d).transpose(1, 2)

    def send(t):
        if not quantize:
            return mesh.all_to_all(t)
        q, sc = _quantize_i8(t)
        q, sc = mesh.all_to_all(q), mesh.all_to_all(sc)
        return (q.to(F32) * sc).to(x2.dtype)

    recv = send(buf)                            # [dst rank, src rank, ...]
    if overlap:
        me = torch.arange(n, device=x2.device)
        h_self = ffn(buf[me, me][:, None])      # independent of the dispatch
        remote = (me[:, None] != me[None, :]).to(recv.dtype)
        h = ffn(recv * remote[..., None, None, None])
        h[me, me] += h_self[:, 0]
    else:
        h = ffn(recv)
    back = mesh.all_to_all(h)                   # combine: [src rank, expert]
    y = _combine(back.reshape(n, E_pad * C, d), slot, gates, keep, k,
                 x2.dtype)
    if cfg.shared_expert:
        y = y + _shared_ffn(p, x2)   # also A2A-independent
    return y


def _pallas_body(x2, p, cfg, *, overlap, quantize, probe=None):
    """The PALLAS_RDMA branch (the serving hot path), per rank on the
    stacked layout: routing and capacity layout as ``_alltoall_body`` up to
    the dst-major capacity buffer, then dispatch -> expert FFN -> combine as
    ONE launch of ``moe_dispatch.cu`` (FLUX knobs: tile-fused COUNTER,
    ``make_schedule([C] * ep, block_tokens=min(64, C), tight=True)``,
    ``contexts=2`` as the reference; ``probe`` records the kernel's marks).
    With ``overlap`` and a shared expert, the
    shared FFN is the kernel's second stream; ``quantize`` is its int8
    wire. The kernel's output slab is ``_alltoall_body``'s ``y_slots``, so
    the combine is shared. One expert per rank (``pallas_moe_eligible``);
    the kernel addresses the ranks' slabs itself, through no mesh."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch_combine
    n, T, d = x2.shape
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    buf, slot, gates, keep = _slots(x2, p["router"], cfg, C, E_pad)
    kw = _kernel_operands(p)
    shared = None
    if overlap and "shared" in p:
        shared = (x2.to(F32).contiguous(), kw["s1"], kw["s2"])
    out = moe_dispatch_combine(
        buf.to(F32).contiguous(), kw["w1"], kw["w2"], counts=[C] * n,
        block_tokens=min(64, C), tight=True, pipelined=True, barrier=False,
        tile_fused=True, wire_i8=quantize, shared=shared, contexts=2,
        probe=probe)
    y_slots, ys = out if shared is not None else (out, None)
    y = _combine(y_slots, slot, gates, keep, k, x2.dtype)
    if "shared" in p:
        y = y + (ys.to(x2.dtype) if ys is not None
                 else _shared_ffn(p, x2))
    return y


def _padded_body(x, p, cfg, n, *, overlap, probe=None):
    """The kernel for a batch that does not shard (B < n or B % n != 0:
    requests admitted on other steps, of other lengths, finishing at other
    times), computing the reference's gathered body for that batch.

    Routing, the capacity ``C = ceil(cf * T * k / E)`` and ``keep`` are
    taken over all T = B*S tokens in global order, exactly as
    :func:`_gathered_body` takes them. The batch is padded to whole rows a
    rank (rank r holds rows [r*Bp/n, (r+1)*Bp/n) of Bp = n*ceil(B/n)); the
    padding rows are never kept, so they take no capacity. Each source
    rank lays its kept rows out at their global slot in its own ``[C] *
    n`` dst-major slab (a source holds at most C of an expert's rows), zero
    elsewhere: ONE launch of ``moe_dispatch.cu`` with the knobs of
    :func:`_pallas_body`, then the combine at the global slots. The
    shared expert runs once per real token, or under ``overlap`` as the
    kernel's second stream over each rank's rows, padding included. Rows
    cross the wire in f32 whatever ``moe_quantize`` says: the reference's
    gathered body has no int8 wire, so quantizing there changes nothing,
    and here neither."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch_combine
    B, S, d = x.shape
    T, Bp = B * S, -(-B // n) * n
    Tl = Bp // n * S                            # tokens a rank, padded
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    gates, idx = _route(x.reshape(1, T, d), p["router"], cfg)
    flat_e, pos, keep = _dispatch_indices(idx, E_pad, C)
    pad = (Bp - B) * S * k
    slot = F.pad(torch.where(keep, flat_e * C + pos, E_pad * C), (0, pad),
                 value=E_pad * C).reshape(n, Tl * k)
    keep = F.pad(keep, (0, pad), value=False).reshape(n, Tl * k)
    gates = F.pad(gates.reshape(1, T * k), (0, pad)).reshape(n, Tl * k)
    x2 = F.pad(x, (0, 0, 0, 0, 0, Bp - B)).reshape(n, Tl, d)
    buf = _lay_out(x2, slot, keep, k, E_pad * C)
    kw = _kernel_operands(p)
    shared = None
    if overlap and "shared" in p:
        shared = (x2.to(F32).contiguous(), kw["s1"], kw["s2"])
    out = moe_dispatch_combine(
        buf.to(F32).contiguous(), kw["w1"], kw["w2"], counts=[C] * n,
        block_tokens=min(64, C), tight=True, pipelined=True, barrier=False,
        tile_fused=True, wire_i8=False, shared=shared, contexts=2,
        probe=probe)
    y_slots, ys = out if shared is not None else (out, None)
    y = _combine(y_slots, slot, gates, keep, k, x.dtype).reshape(Bp, S, d)
    y = y[:B]
    if "shared" in p:
        y = y + (ys.to(x.dtype).reshape(Bp, S, d)[:B] if ys is not None
                 else _shared_ffn(p, x))
    return y


def _kernel_operands(p):
    if "kernel" not in p:
        raise ValueError(
            "moe_backend='pallas' needs the kernel's f32 expert operands "
            "built once: pass params through models.model."
            "with_kernel_weights (the Engine does so itself)")
    return p["kernel"]


def pallas_moe_eligible(cfg, rules, B):
    """Can this (config, sharding, batch) route through the fused dispatch
    kernel? As in the reference: alltoall EP over exactly one data axis,
    no tensor parallelism, and exactly one expert per rank (``E_pad ==
    dp``, the DeepSeek-V3-style serving deployment). Unlike the
    reference, any batch of one row or more: one that shards over the
    data axis runs :func:`_pallas_body`, any other :func:`_padded_body`
    (where the reference takes its XLA bodies)."""
    if rules is None or rules.mesh is None or cfg.ep_mode != "alltoall":
        return False
    dp = rules.dp_size()
    if not dp or B < 1:
        return False
    if len(rules.dp_axes) != 1 or rules.tp_axes:
        return False
    return cfg.num_experts_padded == dp


def _gathered_body(x2, p, cfg, mesh):
    """The XLA body for a batch too small to shard (B < dp or B % dp != 0:
    a decode batch the scheduler has shrunk): the tokens are replicated
    over the data axis (x2 (T, d), every token on every rank), each rank
    runs its own experts over them, and the partial outputs are summed
    across ranks (an all-gather over ``mesh``, then the sum). Runs on the
    host's operators; no kernel."""
    T, d = x2.shape
    n = mesh.n
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    E_l = E_pad // n
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    xr = x2[None].expand(n, T, d)
    e0 = torch.arange(n, device=x2.device) * E_l
    buf, slot, gates, keep = _slots(xr, p["router"], cfg, C, E_l, e0)
    h = _expert_ffn(buf.reshape(n * E_l, C, d), p["wg"], p["wu"], p["wd"])
    part = _combine(h.reshape(n, E_l * C, d), slot, gates, keep, k, x2.dtype)
    y = mesh.all_gather(part, tiled=False)[0].sum(dim=0)   # the psum
    if cfg.shared_expert:
        y = y + _shared_ffn(p, x2)
    return y


# ---------------------------------------------------------------- public API

def moe_apply(params, x, cfg, rules, *, overlap=False, quantize=False,
              backend="xla", probe=None):
    """Apply the MoE block. x: (B, S, d), the whole batch.

    With ``rules`` over a data mesh the batch shards over its ranks (rank r
    takes rows [r*B/dp, (r+1)*B/dp)). ``backend="pallas"`` runs the
    dispatch -> FFN -> combine chain through the Hopper kernel (``probe``,
    a ``ScheduleProbe``, records its marks): :func:`_pallas_body` for a
    batch that shards, :func:`_padded_body` for any other; it raises
    ``ValueError`` where :func:`pallas_moe_eligible` does not hold.
    ``backend="xla"`` takes the all-to-all body, or the gathered body for
    a batch that does not shard."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"moe backend {backend!r}: 'xla' or 'pallas'")
    B, S, d = x.shape
    if backend == "pallas" and not pallas_moe_eligible(cfg, rules, B):
        raise ValueError(
            f"moe_backend='pallas': batch {B} under {rules} with "
            f"{cfg.num_experts_padded} experts ({cfg.ep_mode}) is not "
            "eligible for the kernel (it wants alltoall experts over one "
            "data axis and one expert per rank); the port does not fall "
            "back to another body")
    if rules is None or rules.mesh is None:
        return _local_moe(x, params, cfg)
    if cfg.ep_mode != "alltoall":
        return _replicated_body(x, params, cfg, rules)
    if rules.tp_axes:
        raise NotImplementedError(
            f"moe over tensor-parallel axes {rules.tp_axes} is not ported yet "
            "(ROADMAP queue 1, item 5)")
    mesh = rules.mesh
    dp = rules.dp_size()
    if backend == "pallas":
        if B % dp:
            return _padded_body(x, params, cfg, dp, overlap=overlap,
                                probe=probe)
        y = _pallas_body(x.reshape(dp, B // dp * S, d), params, cfg,
                         overlap=overlap, quantize=quantize, probe=probe)
    elif not rules.dp_axes:             # no data axis: one expert-parallel
        return _local_moe(x, params, cfg)   # rank, as the reference's ep = 1
    elif B % dp == 0 and B >= dp:
        y = _alltoall_body(x.reshape(dp, B // dp * S, d), params, cfg, mesh,
                           overlap=overlap, quantize=quantize)
    else:
        y = _gathered_body(x.reshape(B * S, d), params, cfg, mesh)
    return y.reshape(B, S, d)
