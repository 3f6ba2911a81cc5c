"""Mixture-of-Experts layer with expert parallelism (port of
``repro/models/moe.py``).

Execution modes, as in the reference:

* ``local`` (``rules=None``): full experts on one device; also the oracle
  of the sharded bodies where no token is dropped.
* ``alltoall`` (a :class:`~repro_torch.dist.sharding.Rules` over a
  :class:`~repro_torch.dist.mesh.VirtualMesh` with a data axis): the
  batch and the experts shard over the data ranks, and each expert's
  ``wg``/``wu``/``wd`` over the model axis where there is one (ff tensor
  parallelism: the partial outputs, and the shared expert's, are summed
  over it where the reference sums them). Every body runs per rank on the
  stacked ``(n, ...)`` layout and cuts each rank's weight shard by
  :func:`moe_param_specs` (``dist.sharding.local_shards``).
  ``backend="xla"`` takes :func:`_alltoall_body` (dispatch and combine
  through ``VirtualMesh.all_to_all`` over the data axes, with the
  self/remote split of ``overlap`` and the int8 wire of ``quantize``), or
  :func:`_gathered_body` for a batch that does not shard (B < dp or B %
  dp != 0). ``backend="pallas"``
  takes :func:`_pallas_body`: dispatch -> expert FFN -> combine as one
  launch of the hand-written Hopper kernel ``csrc/moe_dispatch.cu``
  (``kernels.moe_dispatch.moe_dispatch_combine``), with the shared expert
  as its second stream under ``overlap``; a batch that does not shard
  takes :func:`_padded_body`, one launch of the same kernel on a padded
  layout that computes what :func:`_gathered_body` computes.
* ``replicated`` (``ep_mode != "alltoall"``, granite-moe's):
  :func:`_replicated_body`. The batch shards over the data axes; the
  experts shard over the model axis, each rank dispatches its own
  tokens to its own experts only, and the partial outputs (the shared
  expert's ff-sharded partial among them) are summed over the model
  axis. With no model axis every rank runs every expert over its own
  tokens and nothing is summed.

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
  rank, no data axis, no mesh, a model axis, replicated expert
  parallelism) raises ``ValueError``,
  so the kernel is never silently skipped on the main path. The serving
  engine extends the rule to its elastic path: ``Engine.degrade`` onto a
  width the kernel cannot take raises at the degrade, and the caller
  switches to ``backend="xla"`` in the open.
* Under autograd ``backend="pallas"`` raises: a kernel launched through
  the extension returns tensors with no ``grad_fn``, so the input and the
  expert weights would quietly get no gradient. The reference never
  differentiates its Pallas body either (training takes the XLA bodies).
  The host bodies carry gradients, the mesh's collectives and
  ``local_shards`` / ``from_shards`` with them.
* Every body computes the routed and the shared expert FFNs in float32,
  combines them in float32 (gates, the sum over a token's choices, and
  the sums over ranks) and rounds the layer's output to the activation
  type once: the kernel's arithmetic (it takes f32 operands and writes
  f32). The reference's XLA bodies compute in the activation type, so in
  bfloat16 its backends and its meshes differ by bf16 roundings, which a
  top-k router can turn into another expert for a token; the port's
  differ only by the order of f32 sums. In float32 the two packages
  compute the same.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (P, from_shards, local_shards,
                                       replicated, tree_leaves)
from repro_torch.models.layers import dense_init, draw, mlp_apply, mlp_init

F32 = torch.float32


def moe_init(gen, cfg, dtype, device):
    E, d, f = cfg.num_experts_padded, cfg.d_model, cfg.moe_d_ff

    def normal(shape, fan_in):
        w = draw(gen, shape)
        return (w / math.sqrt(fan_in)).to(device=device, dtype=dtype)

    p = {"router": dense_init(gen, d, E, F32, device=device),  # router f32
         "wg": normal((E, d, f), d),
         "wu": normal((E, d, f), d),
         "wd": normal((E, f, d), f)}
    if cfg.shared_expert:
        p["shared"] = mlp_init(gen, d, cfg.moe_d_ff, "swiglu", dtype, device)
    return p


def moe_param_specs(cfg, rules):
    """Specs of the MoE params (``moe_init``'s structure): the experts
    over the data axes (``alltoall``) or the model axis (``replicated``),
    their ff over the model axis in ``alltoall``, the shared expert's ff
    over the model axis."""
    e_ax = rules.axes("experts_data" if cfg.ep_mode == "alltoall"
                      else "experts_model")
    f_ax = rules.axes("ff") if cfg.ep_mode == "alltoall" else None
    specs = {
        "router": P(None, None),
        "wg": P(e_ax, None, f_ax),
        "wu": P(e_ax, None, f_ax),
        "wd": P(e_ax, f_ax, None),
    }
    if cfg.shared_expert:
        specs["shared"] = {"gate": P(None, rules.axes("ff")),
                           "up": P(None, rules.axes("ff")),
                           "down": P(rules.axes("ff"), None)}
    return specs


def _rank_weights(p, cfg, rules):
    """Each rank's shard of the routed experts' weights and of the shared
    expert's, cut by :func:`moe_param_specs`: ``{"experts": {"wg", "wu",
    "wd"}, "shared": {...}}`` with leaves (n, *local shape). A group whose
    specs shard nothing on this mesh stays whole, without the rank axis,
    and ``"whole"`` names it: every rank holds it alike, so it runs once
    over all ranks' rows."""
    specs, mesh = moe_param_specs(cfg, rules), rules.mesh
    groups = {"experts": {k: (p[k], specs[k]) for k in ("wg", "wu", "wd")}}
    if "shared" in p:
        groups["shared"] = {k: (v, specs["shared"][k])
                            for k, v in p["shared"].items()}
    whole = frozenset(g for g, leaves in groups.items()
                      if all(replicated(s, mesh) for _, s in leaves.values()))
    w = {g: {k: t if g in whole else local_shards(t, s, mesh)
             for k, (t, s) in leaves.items()}
         for g, leaves in groups.items()}
    w["whole"] = whole
    return w


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

# active routing recorders; one per ``record_routes()`` context
_ROUTE_SINKS = []


@contextlib.contextmanager
def record_routes(sink=None):
    """Collect every routing a MoE layer makes inside the context, in call
    order, into ``sink`` (anything with ``append``; a new list by default),
    which the context yields: ``(logits, idx)``, the router's f32 logits
    (..., T, E_pad) with the pad experts at -inf, and the top-k expert ids
    (..., T, k). A sharded body routes each rank's rows, so its leading
    axis is the rank's."""
    routes = [] if sink is None else sink
    _ROUTE_SINKS.append(routes)
    try:
        yield routes
    finally:
        _ROUTE_SINKS.remove(routes)


def _route(x2, router_w, cfg):
    """x2: (..., T, d) -> gates (..., T, k) f32, idx (..., T, k)."""
    logits = x2.to(F32) @ router_w.to(F32)                  # (..., T, E_pad)
    E_pad = logits.shape[-1]
    if E_pad > cfg.num_experts:                             # mask pad experts
        pad = torch.arange(E_pad, device=logits.device) >= cfg.num_experts
        logits = logits.masked_fill(pad, -math.inf)
    gates, idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    for sink in _ROUTE_SINKS:
        sink.append((logits, idx))
    return torch.softmax(gates, dim=-1), idx


def _dispatch_indices(idx, E_pad, C):
    """idx: (..., T, k). Returns flat (..., T*k) expert ids, the slot within
    the expert (over each leading index's tokens), keep."""
    flat_e = idx.reshape(*idx.shape[:-2], -1)
    # (..., Tk, E) one-hot by the same ops on every device: F.one_hot
    # checks its range on the host for a CPU tensor and takes other ops on
    # meta, so a count of the step would differ between the two
    oh = (flat_e[..., None] == torch.arange(E_pad, device=flat_e.device)
          ).long()
    pos = ((torch.cumsum(oh, dim=-2) - 1) * oh).sum(dim=-1)    # slot in expert
    return flat_e, pos, pos < C


def _expert_ffn(buf, wg, wu, wd):
    """buf: (E, C, d) x w*: (E, d, f)/(E, f, d) -> (E, C, d) float32.
    SwiGLU, in float32."""
    b = buf.to(F32)
    return (F.silu(b @ wg.to(F32)) * (b @ wu.to(F32))) @ wd.to(F32)


def _rank_ffn(buf, w):
    """Each rank's expert FFN: buf (n, E_l, R, d) the rows of each rank's
    E_l experts, ``w`` the ranks' weights (:func:`_rank_weights`) ->
    (n, E_l, R, d) float32. Experts every rank holds whole run once over
    all ranks' rows."""
    e = w["experts"]
    if "experts" not in w["whole"]:
        return _expert_ffn(buf, e["wg"], e["wu"], e["wd"])
    n, E_l, R, d = buf.shape
    h = _expert_ffn(buf.transpose(0, 1).reshape(E_l, n * R, d),
                    e["wg"], e["wu"], e["wd"])
    return h.reshape(E_l, n, R, d).transpose(0, 1)


def _shared_ffn(sh, x2):
    """The shared expert's weights ``sh`` over the rows x2, in float32:
    whole weights over any rows, or each rank's shard (n, ...) over its
    own rows x2 (n, T, d)."""
    w = {k: v.to(F32) for k, v in sh.items()}
    return mlp_apply(w, x2.to(F32), "swiglu")


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


def _combine(y_slots, slot, gates, keep, k):
    """Each (token, choice)'s expert row, gated, summed per token: y_slots
    (n, E*C, d) -> (n, T, d) float32. A token's k rows are added in choice
    order, as the reference's scatter-add takes them, and in the same
    order on every call (an atomic scatter-add on a card would change it
    from call to call, and a greedy stream with it)."""
    n, EC, d = y_slots.shape
    rows = slot.clamp(max=EC - 1)
    contrib = torch.gather(y_slots.to(F32), 1,
                           rows[..., None].expand(-1, -1, d))
    contrib = contrib * (gates.reshape(n, -1, 1) * keep[..., None])
    contrib = contrib.reshape(n, -1, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


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
    y = _combine(h.reshape(1, E_pad * C, d), slot, gates, keep, k)
    if cfg.shared_expert:
        y = y + _shared_ffn(p["shared"], x2)
    return y.to(x.dtype).reshape(B, S, d)


def _replicated_body(x2, p, cfg, rules):
    """Experts sharded over the model axis, per rank on the stacked
    layout: x2 (n, T, d) each rank's tokens (its data shard of the batch,
    the same on every rank of a model group). Rank r holds experts [m*E_l,
    (m+1)*E_l) with m its model coordinate, dispatches only its tokens'
    slots in those experts (capacity from its own T tokens), and the
    partial outputs, the shared expert's ff-sharded partial included, are
    summed over the model axis. No model axis: every rank holds every
    expert and nothing is summed."""
    mesh = rules.mesh
    n, T, d = x2.shape
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    w = _rank_weights(p, cfg, rules)
    E_l = w["experts"]["wg"].shape[-3]
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    e0 = mesh.axis_index(rules.tp_axes) % (E_pad // E_l) * E_l
    buf, slot, gates, keep = _slots(x2, p["router"], cfg, C, E_l, e0)
    h = _rank_ffn(buf.reshape(n, E_l, C, d), w)
    y = _combine(h.reshape(n, E_l * C, d), slot, gates, keep, k)
    if cfg.shared_expert:
        y = y + _shared_ffn(w["shared"], x2)  # ff-sharded partial: psummed
    return mesh.psum(y, rules.tp_axes).to(x2.dtype)


def _alltoall_body(x2, p, cfg, rules, *, overlap, quantize):
    """Paper-faithful EP per rank on the stacked layout: x2 (n, T, d), each
    rank's tokens (its data shard; the same on every rank of a model
    group); the rank at data coordinate e holds experts [e*E_l,
    (e+1)*E_l), their ff shard at its model coordinate. Dispatch
    all-to-all over the data axes -> expert FFN (its ff-sharded partial
    summed over the model axis) -> combine all-to-all, through the mesh.

    With ``overlap`` the self chunk's FFN is computed from each rank's own
    send buffer (no dependency on the dispatch all-to-all) and the
    received self rows are zero-masked, as in the reference's two-stream
    split. ``quantize`` sends the dispatch as int8 with per-row scales."""
    mesh, dp_axes, tp_axes = rules.mesh, rules.dp_axes, rules.tp_axes
    n, T, d = x2.shape
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    ep = rules.dp_size()
    E_l = E_pad // ep
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    w = _rank_weights(p, cfg, rules)
    buf, slot, gates, keep = _slots(x2, p["router"], cfg, C, E_pad)
    buf = buf.reshape(n, ep, E_l, C, d)         # [rank, dst data rank, ...]

    def ffn(chunk):
        """chunk (n, m src, E_l, C, d): each rank's FFN over the rows it
        holds, its tokens grouped by expert; ff partials summed."""
        m = chunk.shape[1]
        cg = chunk.transpose(1, 2).reshape(n, E_l, m * C, d)
        h = mesh.psum(_rank_ffn(cg, w), tp_axes)
        return h.reshape(n, E_l, m, C, d).transpose(1, 2)

    def send(t):
        if not quantize:
            return mesh.all_to_all(t, dp_axes)
        q, sc = _quantize_i8(t)
        q, sc = mesh.all_to_all(q, dp_axes), mesh.all_to_all(sc, dp_axes)
        return (q.to(F32) * sc).to(x2.dtype)

    recv = send(buf)                            # [rank, src data rank, ...]
    if overlap:
        me, own = torch.arange(n, device=x2.device), mesh.axis_index(dp_axes)
        h_self = ffn(buf[me, own][:, None])     # independent of the dispatch
        src = torch.arange(ep, device=x2.device)
        remote = (own[:, None] != src[None, :]).to(recv.dtype)
        h = ffn(recv * remote[..., None, None, None])
        h[me, own] += h_self[:, 0]
    else:
        h = ffn(recv)
    back = mesh.all_to_all(h, dp_axes)          # combine: [rank, expert]
    y = _combine(back.reshape(n, E_pad * C, d), slot, gates, keep, k)
    if cfg.shared_expert:                       # also A2A-independent
        y = y + mesh.psum(_shared_ffn(w["shared"], x2), tp_axes)
    return y.to(x2.dtype)


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
    y = _combine(y_slots, slot, gates, keep, k)
    if "shared" in p:
        y = y + (ys if ys is not None else _shared_ffn(p["shared"], x2))
    return y.to(x2.dtype)


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
    y = _combine(y_slots, slot, gates, keep, k).reshape(Bp, S, d)
    y = y[:B]
    if "shared" in p:
        y = y + (ys.reshape(Bp, S, d)[:B] if ys is not None
                 else _shared_ffn(p["shared"], x))
    return y.to(x.dtype)


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


def _gathered_body(x2, p, cfg, rules):
    """The XLA body for a batch too small to shard (B < dp or B % dp != 0:
    a decode batch the scheduler has shrunk): the tokens are replicated
    over every rank (x2 (T, d)), each rank runs its own experts (those at
    its data coordinate, their ff shard at its model coordinate) over
    them, the ff partials are summed over the model axis and the partial
    outputs over the data axes; the shared expert's ff partials are summed
    over the model axis. Runs on the host's operators; no kernel."""
    mesh = rules.mesh
    n = mesh.n
    T, d = x2.shape
    k, E_pad = cfg.experts_per_token, cfg.num_experts_padded
    w = _rank_weights(p, cfg, rules)
    E_l = w["experts"]["wg"].shape[-3]
    C = _capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    xr = x2[None].expand(n, T, d)
    e0 = mesh.axis_index(rules.dp_axes) % (E_pad // E_l) * E_l
    buf, slot, gates, keep = _slots(xr, p["router"], cfg, C, E_l, e0)
    h = mesh.psum(_rank_ffn(buf.reshape(n, E_l, C, d), w), rules.tp_axes)
    part = _combine(h.reshape(n, E_l * C, d), slot, gates, keep, k)
    y = mesh.psum(part, rules.dp_axes)[0]
    if cfg.shared_expert:
        if "shared" in w["whole"]:         # the whole expert: once
            y = y + _shared_ffn(w["shared"], x2)
        else:                              # ff-sharded partials, summed
            y = y + mesh.psum(_shared_ffn(w["shared"], xr), rules.tp_axes)[0]
    return y.to(x2.dtype)


# ---------------------------------------------------------------- public API


def moe_apply(params, x, cfg, rules, *, overlap=False, quantize=False,
              backend="xla", probe=None):
    """Apply the MoE block. x: (B, S, d), the whole batch.

    With ``rules`` the batch shards over the mesh's data ranks (the rank at
    data coordinate r takes rows [r*B/dp, (r+1)*B/dp); every rank of a
    model group holds the same rows). ``backend="pallas"`` runs the
    dispatch -> FFN -> combine chain through the Hopper kernel (``probe``,
    a ``ScheduleProbe``, records its marks): :func:`_pallas_body` for a
    batch that shards, :func:`_padded_body` for any other; it raises
    ``ValueError`` where :func:`pallas_moe_eligible` does not hold, and
    where autograd would record through ``x`` or any weight.
    ``backend="xla"`` takes the all-to-all body (the gathered body for a
    batch that does not shard) for ``alltoall`` experts, the replicated
    body for the others."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"moe backend {backend!r}: 'xla' or 'pallas'")
    if backend == "pallas" and torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves({"x": x, "p": params})):
        raise ValueError(
            "moe_backend='pallas' under autograd: the moe_dispatch.cu kernel "
            "has no backward, so the MoE input and the expert weights would "
            "get no gradient; train with moe_backend='xla'")
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
    if not rules.dp_axes and not rules.tp_axes:  # one expert-parallel rank,
        return _local_moe(x, params, cfg)        # as the reference's ep = 1
    mesh = rules.mesh
    dp = rules.dp_size()
    b_ok = B % dp == 0 and B >= dp
    if backend == "pallas" and not b_ok:
        return _padded_body(x, params, cfg, dp, overlap=overlap, probe=probe)
    if cfg.ep_mode == "alltoall" and not b_ok:
        return _gathered_body(x.reshape(B * S, d), params, cfg,
                              rules).reshape(B, S, d)
    # each rank's rows: its data shard of the batch, or (a replicated
    # body's batch that does not shard) the whole batch on every rank
    spec = P(rules.dp_axes if b_ok else None)
    xs = local_shards(x, spec, mesh)
    x2 = xs.reshape(mesh.n, -1, d)
    if backend == "pallas":
        y = _pallas_body(x2, params, cfg, overlap=overlap, quantize=quantize,
                         probe=probe)
    elif cfg.ep_mode == "alltoall":
        y = _alltoall_body(x2, params, cfg, rules, overlap=overlap,
                           quantize=quantize)
    else:
        y = _replicated_body(x2, params, cfg, rules)
    return from_shards(y.reshape(xs.shape), spec, mesh)
