"""Workload 6: LongCat-Flash's shortcut-connected MoE (ScMoE) double-layer,
attention left out: a real router over FFN and zero-compute experts, and
a dense FFN beside the dispatch.

For h (n, T, d), each rank's T tokens (``models/longcat_ref.py`` holds
the equations and is the reference):

    u = RMSNorm0(h); scores = softmax(u Wr) over E + Z outputs (float32)
    picks = top-k of scores + b; g = scale * score of each pick
    m = sum over picks, in pick order, of g * SwiGLU_j(u) (FFN expert
        j < E) or g * u (zero expert)
    out = h1 + FFN2(RMSNorm1(h1)) + m, h1 = h + FFN1(u)

The MoE reads FFN1's input and is added only at the end: its dispatch and
combine may run beside FFN1, the paper's two-stream pattern with a dense
FFN as the local compute. Expert j's weights are tensor ``j % n``, which
rank ``j % n`` holds: the chip's share of an expert-parallel deployment,
in which every FFN pick is computed (a token's two picks on one rank are
two rows, never merged).

Realizations (cascade l2 holds each to :meth:`ScMoEStep.reference`):

* host (``CONSERVATIVE``): route, a padded all-to-all of the picked rows
  on the :class:`~repro_torch.dist.mesh.VirtualMesh`, the experts, the
  all-to-all back, FFN1, the gates, FFN2, strictly in turn.
* ``STREAM_SPLIT``: FFN1 issued before the dispatch all-to-all, with no
  dependence on it.
* PALLAS_RDMA / HYBRID: ``kernels/moe_dispatch``'s kernel on a table of
  rows per (source, destination) pair, FFN1 as its second stream over the
  rank's own tokens; the router GEMM and FFN2 on its tile GEMM alone
  (``gemm_core``, 3xTF32: float32 accuracy). The table is read on the
  host before the launch (span ``scmoe.route``).

Spans ``scmoe.route``, ``scmoe.combine`` and ``scmoe.ffn2`` sit beside
``moe_dispatch.call``, never around it; each launch notes its FFN rows,
zero picks and largest pair (``src/repro_torch/OBSERVABILITY.md``).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.cost_model import (CostBreakdown, CostSegment,
                                         per_tile_exposed_s,
                                         window_stall_factor)
from repro_torch.core.design_space import Directive
from repro_torch.kernels.moe_dispatch import (make_schedule, quant_i8,
                                              swiglu_ffn)
from repro_torch.workloads.base import (BARRIER_OVERHEAD, KERNEL_LAUNCH,
                                        SIGNAL_OVERHEAD, TILE_SYNC, register)
from repro_torch.workloads.moe_dispatch import MoEDispatch

# active pick recorders; one per ``record_routes()`` context
_ROUTE_SINKS = []


@contextlib.contextmanager
def record_routes(sink=None):
    """Collect the picks of every ScMoE layer run inside the context, in
    call order, into ``sink`` (a new list by default), which the context
    yields: each an (n, T, k) tensor of expert ids in pick order, on the
    layer's device (no copy, no synchronize)."""
    routes = [] if sink is None else sink
    _ROUTE_SINKS.append(routes)
    try:
        yield routes
    finally:
        _ROUTE_SINKS.remove(routes)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


@register
class ScMoEStep(MoEDispatch):
    name = "scmoe_step"
    ring_topology = False
    kernelizable = True
    second_stream = True          # FFN1 rides the kernel

    def __init__(self, n_dev=8, tokens_per_rank=128, d=6144, f=2048,
                 f_dense=12288, n_experts=512, n_zero=256, topk=12,
                 scale=6.0, eps=1e-5, axis="x"):
        super().__init__(n_dev=n_dev, tokens_per_rank=tokens_per_rank, d=d,
                         f=f, skew=1.0, axis=axis)
        self.f_dense = f_dense
        self.n_experts = n_experts
        self.n_zero = n_zero
        self.topk = topk
        self.scale = float(scale)
        self.eps = float(eps)

    def _counts(self, T):
        """Rows each rank sends each expert rank at the router's mean: a
        token's k picks land on an FFN expert with chance E / (E + Z), the
        FFN experts spread evenly over the ranks. The l3 model and the l0
        schedule take it; a step routes by its own picks."""
        rows = round(T * self.topk * self.n_experts
                     / (self.n_experts + self.n_zero))
        counts = np.full(self.n_dev, rows // self.n_dev)
        counts[:rows % self.n_dev] += 1
        return counts

    def degrade(self, live_ranks, capacity_factor=1.25):
        raise NotImplementedError(
            f"{self.name} has no degraded-mode reshape: expert j's weights "
            "live on rank j mod n")

    def state_bytes_per_rank(self):
        d = self.d
        return 4 * (self.T * d + 3 * d * self.f + 6 * d * self.f_dense
                    + d * (self.n_experts + self.n_zero))

    # ------------------------------------------------------------- inputs
    def example_inputs(self, seed, mesh, T=None):
        """h (n, T, d) and one double-layer's weights from ``seed``: wr
        (d, E + Z), b (E + Z) zero, w1 (n, d, 2f), w2 (n, f, d), the dense
        FFNs s1 / t1 (d, 2 fd), s2 / t2 (fd, d), the norms g0 / g1 (d)
        one."""
        T = T or min(self.T, 64)
        n, d, f, fd = self.n_dev, self.d, self.f, self.f_dense
        g = torch.Generator(device=mesh.device).manual_seed(int(seed))
        kw = dict(generator=g, device=mesh.device, dtype=torch.float32)

        def normal(*shape):
            return torch.randn(shape, **kw) / math.sqrt(shape[-2])

        h = torch.randn((n, T, d), **kw)
        wr = normal(d, self.n_experts + self.n_zero)
        b = torch.zeros(self.n_experts + self.n_zero, device=mesh.device)
        w1, w2 = normal(n, d, 2 * f), normal(n, f, d)
        s1, s2, t1, t2 = (normal(d, 2 * fd), normal(fd, d),
                          normal(d, 2 * fd), normal(fd, d))
        ones = torch.ones(d, device=mesh.device)
        return h, wr, b, w1, w2, s1, s2, t1, t2, ones, ones.clone()

    def reference(self, h, wr, b, w1, w2, s1, s2, t1, t2, g0, g1):
        from repro_torch.models import longcat_ref
        layer = dict(zip(longcat_ref.LAYER_KEYS,
                         (wr, b, w1, w2, s1, s2, t1, t2, g0, g1)))
        return longcat_ref.double_layer(
            h, layer, n_experts=self.n_experts, topk=self.topk,
            scale=self.scale, eps=self.eps)[0]

    # --------------------------------------------------------- the layer
    def _pick(self, scores, b):
        return torch.topk(scores + b, self.topk, dim=-1).indices

    def _route(self, u, wr, b, mm):
        """The router on u (n, T, d) with the product ``mm``: picks and
        gates (n, T, k), handed to every :func:`record_routes` sink."""
        n, T, d = u.shape
        scores = torch.softmax(mm(u.reshape(n * T, d), wr), dim=-1)
        picks = self._pick(scores, b)
        gates = self.scale * scores.gather(-1, picks)
        picks = picks.view(n, T, self.topk)
        for sink in _ROUTE_SINKS:
            sink.append(picks)
        return picks, gates.view(n, T, self.topk)

    def _layout(self, u, picks):
        """Each rank's picked rows in the kernel's layout: its FFN picks
        sorted by the rank that holds their expert (j mod n), in (token,
        pick) order within a rank, its zero picks after them. Returns the
        rows (n, T k, d), the rows of each (source, destination) pair (n,
        n) on the device, and each pick's row (n, T, k) and FFN mask."""
        n, T, k = picks.shape
        ffn = picks < self.n_experts
        dest = torch.where(ffn, picks % n, n).view(n, T * k)
        order = torch.sort(dest, dim=1, stable=True).indices
        where = torch.empty_like(order).scatter_(
            1, order, torch.arange(T * k, device=u.device).expand(n, -1))
        rows = torch.gather(u, 1, (order // k).unsqueeze(-1).expand(
            -1, -1, u.shape[-1]))
        pairs = torch.zeros((n, n + 1), dtype=torch.int64, device=u.device)
        pairs.scatter_add_(1, dest, torch.ones_like(dest))
        return rows, pairs[:, :n], where.view(n, T, k), ffn

    def _note(self, counts, picks):
        rows = sum(map(sum, counts))
        telemetry.note("scmoe.ffn_rows", rows)
        telemetry.note("scmoe.zero_picks", picks.numel() - rows)
        telemetry.note("scmoe.max_pair", max(map(max, counts)))

    def _combine(self, y, u, where, ffn, gates):
        """m: each pick's row of the expert output y (n, T k, d), or u for a
        zero pick, times its gate, summed in pick order in float32."""
        n, T, k = where.shape
        got = torch.gather(y, 1, where.view(n, T * k, 1).expand(
            -1, -1, y.shape[-1])).view(n, T, k, -1)
        m = torch.zeros_like(u)
        for i in range(k):
            v = torch.where(ffn[:, :, i, None], got[:, :, i], u)
            m = m + gates[:, :, i, None] * v
        return m

    def _ffn2(self, h, ys, m, g1, t1, t2, mm):
        """out = h1 + FFN2(RMSNorm1(h1)) + m, h1 = h + FFN1(u) (= ys)."""
        n, T, d = h.shape
        h1 = h + ys
        z = rms_norm(h1, g1, self.eps).view(n * T, d)
        return h1 + mm(mm(z, t1, swiglu=True), t2).view(n, T, d) + m

    # ------------------------------------------------------------ builders
    def _make(self, mesh, *, overlap, wire_i8):
        n = self.n_dev

        def mm(a, b, swiglu=False):
            c = a @ b
            if not swiglu:
                return c
            g, v = torch.chunk(c, 2, dim=-1)
            return torch.nn.functional.silu(g) * v

        def wire(t):
            if wire_i8:
                q, s = quant_i8(t)
                return mesh.all_to_all(q).to(torch.float32) \
                    * mesh.all_to_all(s)
            return mesh.all_to_all(t)

        def run(h, wr, b, w1, w2, s1, s2, t1, t2, g0, g1):
            u = rms_norm(h, g0, self.eps)
            picks, gates = self._route(u, wr, b, mm)
            rows, pairs, where, ffn = self._layout(u, picks)
            if overlap:
                # FFN1 has no dependence on the dispatch wire: under
                # STREAM_SPLIT it may run while the all-to-all is in flight
                ys = swiglu_ffn(u, s1, s2)
            counts = pairs.tolist()
            C = max(1, max(map(max, counts)))
            d = u.shape[-1]
            send = rows.new_zeros((n, n, C, d))           # [source, expert]
            for s in range(n):
                off = 0
                for e, c in enumerate(counts[s]):
                    send[s, e, :c] = rows[s, off:off + c]
                    off += c
            got = wire(send)                              # [expert, source]
            out = swiglu_ffn(got.reshape(n, n * C, d), w1, w2)
            back = mesh.all_to_all(out.reshape(n, n, C, d))
            y = torch.zeros_like(rows)
            for s in range(n):
                off = 0
                for e, c in enumerate(counts[s]):
                    y[s, off:off + c] = back[s, e, :c]
                    off += c
            if not overlap:
                ys = swiglu_ffn(u, s1, s2)
            m = self._combine(y, u, where, ffn, gates)
            return self._ffn2(h, ys, m, g1, t1, t2, mm)

        return run

    def _make_kernel(self, mesh, d: Directive):
        from repro_torch.kernels import moe_dispatch as kern
        k = self.kernel_knobs(d)

        def run(h, wr, b, w1, w2, s1, s2, t1, t2, g0, g1):
            with telemetry.span("scmoe.route"):
                u = rms_norm(h, g0, self.eps)
                picks, gates = self._route(u, wr, b, kern.gemm_core)
                rows, pairs, where, ffn = self._layout(u, picks)
                counts = pairs.tolist()       # the host reads the table
                self._note(counts, picks)
            y, ys = kern.moe_dispatch_combine(
                rows, w1, w2, counts=counts,
                block_tokens=k["block_tokens"], tight=k["tight"],
                pipelined=k["pipelined"], barrier=k["barrier"],
                tile_fused=k["tile_fused"], combine_tile=k["combine_tile"],
                wire_i8=bool(k["wire_i8"]), shared=(u, s1, s2),
                contexts=k["contexts"])
            with telemetry.span("scmoe.combine"):
                m = self._combine(y, u, where, ffn, gates)
            with telemetry.span("scmoe.ffn2"):
                return self._ffn2(h, ys, m, g1, t1, t2, kern.gemm_core)

        return run

    # --------------------------------------------------------- l3 cost model
    def cost_breakdown(self, d: Directive, hw) -> CostBreakdown:
        """One rank's double-layer at the router's mean (:meth:`_counts`):
        the router, the routed FFN rows, FFN1 and FFN2 over its T tokens,
        the dispatch and combine of its off-rank rows. The kernel's
        tile-fused path prices FFN1 and the routed FFN against the
        dispatch (the two-stream span)."""
        Seg = CostSegment
        n, T, dm, f, fd = self.n_dev, self.T, self.d, self.f, self.f_dense
        peak = hw.chip.peak_bf16_flops
        counts = self._counts(T)
        rows = int(counts.sum())
        kernel = d.backend in ("PALLAS_RDMA", "HYBRID")
        k = self.kernel_knobs(d) if kernel else None
        wire_i8 = bool(d.tunable("wire_i8", 0))
        t_router = 2 * T * dm * (self.n_experts + self.n_zero) / peak
        t_routed = 3 * 2 * rows * dm * f / peak
        t_ffn1 = 3 * 2 * T * dm * fd / peak
        t_ffn2 = t_ffn1
        sent = rows - int(counts[0])
        t_disp = sent * dm * (1 if wire_i8 else 2) / hw.chip.ici_link_bw
        t_comb = sent * dm * 2 / hw.chip.ici_link_bw
        t_quant = (2 * rows * dm * 2 / hw.chip.hbm_bw) if wire_i8 else 0.0
        t_gates = 2 * self.topk * T * dm * 4 / hw.chip.hbm_bw
        local = (Seg("router", t_router, "compute"),
                 Seg("gates", t_gates, "compute"),
                 Seg("ffn2", t_ffn2, "compute"))

        if kernel:
            B = k["block_tokens"]
            sched = make_schedule(counts, B, k["tight"])
            disp_rounds = sched.issued_rounds(elide_dummy=True)
            ticks = sched.combine_ticks(k["combine_tile"], rank=0,
                                        elide_dummy=True) \
                if k["tile_fused"] \
                else sched.combine_issued_rounds(0, elide_dummy=True)
            if k["tile_fused"]:
                sync = 0.0
            elif d.completion == "BARRIER":
                sync = BARRIER_OVERHEAD
            else:
                sync = SIGNAL_OVERHEAD * max(1, n - 1)
            tail = local + (
                Seg("quant", t_quant, "quant"),
                Seg("sync", sync, "sync"),
                Seg("launch", 3 * KERNEL_LAUNCH, "launch"),
                Seg("tile_sync", (disp_rounds + ticks) * TILE_SYNC, "sync",
                    meta={"issued_rounds": disp_rounds, "ticks": ticks}),
            )
            if k["tile_fused"]:
                # FFN1 is issued against the open send window, then the
                # routed tiles run as arrivals land; the wire track is the
                # dispatch
                startup = t_disp / max(1, disp_rounds)
                span = max(t_disp, startup + t_ffn1 + t_routed)
                return CostBreakdown(segments=(
                    Seg("two_stream_span", span, "overlap",
                        meta={"wire_s": t_disp,
                              "compute_s": startup + t_ffn1 + t_routed}),
                    Seg("window_stall", window_stall_factor(k["contexts"])
                        * per_tile_exposed_s(sent * dm * 2,
                                             hw.chip.ici_link_bw, ticks),
                        "stall", meta={"contexts": k["contexts"]}),
                ) + tail, schedule=sched, knobs=k,
                    meta={"path": "kernel_two_stream"})
            return CostBreakdown(segments=(
                Seg("two_stream", max(t_disp, t_ffn1), "overlap",
                    meta={"wire_s": t_disp, "compute_s": t_ffn1}),
                Seg("expert_ffn", t_routed, "compute"),
                Seg("combine", t_comb, "wire"),
            ) + tail, schedule=sched, knobs=k,
                meta={"path": "kernel_deferred_two_stream"})

        sync = BARRIER_OVERHEAD if d.completion == "BARRIER" \
            else SIGNAL_OVERHEAD
        launches = KERNEL_LAUNCH * 7      # router, a2a, experts, a2a, FFNs
        if d.placement == "STREAM_SPLIT":
            return CostBreakdown(segments=(
                Seg("two_stream", max(t_disp + t_quant, t_ffn1), "overlap",
                    meta={"wire_s": t_disp + t_quant, "compute_s": t_ffn1}),
                Seg("expert_ffn", t_routed, "compute"),
                Seg("combine", t_comb, "wire"),
                Seg("sync", sync, "sync"),
                Seg("launch", launches, "launch"),
            ) + local, meta={"path": "xla_two_stream"})
        return CostBreakdown(segments=(
            Seg("quant", t_quant, "quant"),
            Seg("dispatch", t_disp, "wire"),
            Seg("expert_ffn", t_routed, "compute"),
            Seg("combine", t_comb, "wire"),
            Seg("ffn1", t_ffn1, "compute"),
            Seg("sync", sync, "sync"),
            Seg("launch", launches, "launch"),
        ) + local, meta={"path": "xla_host"})
