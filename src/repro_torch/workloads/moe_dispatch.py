"""Workload 2: DeepSeek-V3 MoE dispatch/combine under skewed routing
(paper §4.3, Table 5, Figure 8). Port of ``repro/workloads/moe_dispatch.py``.

Pipeline: (quantize) -> dispatch all-to-all -> expert GEMM1+SwiGLU+GEMM2 ->
combine all-to-all. Each rank owns one expert; routing is skewed (2:1..5:1)
so ranks are imbalanced.

Every builder takes and returns the stacked rank layout: x (n, T, d),
w1 (n, d, 2f), w2 (n, f, d), expert e's weights on rank e.

* Host baseline (the paper's "standard sequential flow"): padded
  equal-size all-to-all on the :class:`~repro_torch.dist.mesh.VirtualMesh`,
  strictly sequential — quantize, dispatch, compute, combine.
* STREAM_SPLIT: the self/remote split — the local expert's tokens never
  touch the wire, and their FFN has no dependence on the dispatch.
* PALLAS_RDMA / HYBRID: the fused device-initiated Hopper kernel
  (``repro_torch.kernels.moe_dispatch``) at tight per-peer sizes.

``kernel_knobs`` is the single directive→knob mapping both ``build()`` and
``cost_breakdown()`` consult; ``cost_breakdown`` is the reference's, line
for line, priced on whichever ``ChipSpec`` the context names.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.cost_model import (CostBreakdown, CostSegment,
                                         per_tile_exposed_s,
                                         window_stall_factor)
from repro_torch.core.design_space import Directive
from repro_torch.kernels.moe_dispatch import (make_schedule, quant_i8,
                                              swiglu_ffn)
from repro_torch.workloads.base import (BARRIER_OVERHEAD, KERNEL_LAUNCH,
                                        SIGNAL_OVERHEAD, TILE_SYNC, Workload,
                                        register)
from repro_torch.workloads.base import inputs_from_numpy  # noqa: F401


@register
class MoEDispatch(Workload):
    name = "moe_dispatch"
    ring_topology = False
    kernelizable = True           # repro_torch.kernels.moe_dispatch
    second_stream = False         # the kernel runs no shared-expert stream

    def __init__(self, n_dev=4, tokens_per_rank=4096, d=512, f=1024,
                 skew=3.0, axis="x", route_weights=None):
        self.n_dev = n_dev
        self.T = tokens_per_rank
        self.d = d
        self.f = f
        self.skew = skew
        self.axis = axis
        # explicit routing shares override the skew law — the degraded
        # (post-respill) instances carry their re-routed distribution here
        self.route_weights = None if route_weights is None \
            else tuple(float(v) for v in route_weights)

    # deterministic skewed routing: expert e's share ~ skew^(-e); identical
    # on every rank; tokens sorted into contiguous per-expert blocks.
    def _counts(self, T):
        if self.route_weights is not None:
            w = np.array(self.route_weights, dtype=float)
        else:
            w = np.array([self.skew ** (-e) for e in range(self.n_dev)])
        w = w / w.sum()
        counts = np.floor(w * T).astype(int)
        counts[0] += T - counts.sum()
        return counts

    # ------------------------------------------- fault contract (core/faults)
    def degrade(self, live_ranks, capacity_factor=1.25):
        """Dead experts' tokens respill across the survivors; the respilled
        counts become the degraded instance's routing shares."""
        from repro_torch.core.schedule import check_live, respill_counts
        live = check_live(live_ranks, self.n_dev)
        if len(live) == self.n_dev:
            return self
        new_counts = respill_counts(self._counts(self.T), live,
                                    capacity_factor)
        return type(self)(n_dev=len(live), tokens_per_rank=self.T, d=self.d,
                          f=self.f, skew=self.skew, axis=self.axis,
                          route_weights=new_counts)

    def state_bytes_per_rank(self):
        # resident activations + the rank's expert weights (f32)
        return 4 * (self.T * self.d
                    + self.d * 2 * self.f + self.f * self.d)

    def example_inputs(self, seed, mesh, T=None):
        """Random inputs from ``seed`` on ``mesh.device`` (a torch
        Generator; the tests use :func:`inputs_from_numpy` instead)."""
        T = T or min(self.T, 256)
        g = torch.Generator(device=mesh.device).manual_seed(int(seed))
        kw = dict(generator=g, device=mesh.device, dtype=torch.float32)
        x = torch.randn((self.n_dev, T, self.d), **kw)
        w1 = torch.randn((self.n_dev, self.d, 2 * self.f), **kw) \
            / math.sqrt(self.d)
        w2 = torch.randn((self.n_dev, self.f, self.d), **kw) \
            / math.sqrt(self.f)
        return x, w1, w2

    def _ffn(self, x, w1, w2):
        return swiglu_ffn(x, w1, w2)

    def reference(self, x, w1, w2):
        n, T, _ = x.shape
        out = torch.zeros_like(x)
        off = 0
        for e, c in enumerate(self._counts(T)):
            c = int(c)
            out[:, off:off + c] = self._ffn(x[:, off:off + c], w1[e], w2[e])
            off += c
        return out

    # ------------------------------------------------------------- builders
    def _make(self, mesh, *, overlap, wire_i8):
        n = self.n_dev

        def run(x, w1, w2):
            T, d = x.shape[1], x.shape[2]
            counts = self._counts(T)
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            C = int(counts.max())
            send = x.new_zeros((n, n, C, d))               # [rank, expert]
            for e in range(n):
                o, c = int(offsets[e]), int(counts[e])
                send[:, e, :c] = x[:, o:o + c]

            def wire(t):
                if wire_i8:
                    q, s = quant_i8(t)
                    return (mesh.all_to_all(q).to(torch.float32)
                            * mesh.all_to_all(s))
                return mesh.all_to_all(t)

            if overlap:
                # self/remote split: self-chunk FFN has no a2a dependence
                xp = torch.cat([x, x.new_zeros((n, C, d))], dim=1)
                self_blk = torch.stack([
                    xp[r, int(offsets[r]):int(offsets[r]) + C]
                    for r in range(n)])
                h_self = self._ffn(self_blk, w1, w2)      # overlaps dispatch
                got = wire(send)                          # [expert, source]
                self_edge = torch.eye(n, dtype=torch.bool, device=x.device)
                got = got.masked_fill(self_edge[:, :, None, None], 0.0)
            else:
                got = wire(send)                          # sequential chain

            h = self._ffn(got.reshape(n, n * C, d), w1, w2).reshape(n, n, C, d)
            back = mesh.all_to_all(h)                     # combine
            y = torch.zeros_like(x)
            for e in range(n):                            # unpack padded blocks
                o, c = int(offsets[e]), int(counts[e])
                y[:, o:o + c] = back[:, e, :c]
            if overlap:                                   # merge self chunk
                for r in range(n):
                    o, c = int(offsets[r]), int(counts[r])
                    y[r, o:o + c] = h_self[r, :c]
            return y

        return run

    def host_baseline(self, mesh):
        return self._make(mesh, overlap=False, wire_i8=False)

    # directive -> kernel-knob mapping shared by build() and analytic_cost()
    def kernel_knobs(self, d: Directive):
        k = super().kernel_knobs(d)      # tunables (raw) + contexts
        B = max(1, int(k["block_tokens"]))
        k.update(
            block_tokens=B,
            # PER_TILE (the FLUX coordinate) quantizes to microblocks too —
            # both per-peer and per-tile edges carry exact token counts
            tight=(d.granularity in ("PER_PEER", "PER_TILE")
                   and bool(k["tight"])),
            # BARRIER forces the global-rendezvous shape even under a
            # TILE_FUSED placement; COUNTER/SIGNAL fuse the combine loop
            tile_fused=(d.placement == "TILE_FUSED"
                        and d.completion != "BARRIER"),
            # combine_tile stays raw (default: one tile per microblock) —
            # the kernel entry and the schedule's combine_ticks each
            # sanitize at their own boundary
            combine_tile=d.tunable("combine_tile", B),
            pipelined=d.placement in ("TILE_FUSED", "TILE_PIPELINED",
                                      "STREAM_SPLIT"),
            barrier=d.completion == "BARRIER")
        return k

    def collective_schedule(self, d: Directive):
        # the exact schedule _make_kernel hands the kernel at the
        # deployment token count — l0 (core/verify.py) lowers and checks
        # it before any build is attempted
        if d.backend not in ("PALLAS_RDMA", "HYBRID"):
            return None
        k = self.kernel_knobs(d)
        return make_schedule(self._counts(self.T), k["block_tokens"],
                             k["tight"])

    def _make_kernel(self, mesh, d: Directive):
        from repro_torch.kernels.moe_dispatch import moe_dispatch_combine
        k = self.kernel_knobs(d)

        def run(x, w1, w2):
            return moe_dispatch_combine(
                x, w1, w2, counts=self._counts(x.shape[1]),
                block_tokens=k["block_tokens"], tight=k["tight"],
                pipelined=k["pipelined"], barrier=k["barrier"],
                tile_fused=k["tile_fused"], combine_tile=k["combine_tile"],
                wire_i8=bool(k["wire_i8"]), contexts=k["contexts"])

        return run

    def load_kernels(self, d: Directive, mesh) -> str:
        if d.backend not in ("PALLAS_RDMA", "HYBRID"):
            return super().load_kernels(d, mesh)
        from repro_torch.kernels import moe_dispatch as kern
        if mesh.device.type != "cuda":
            return "moe_dispatch plain version (cpu tensors)"
        k = self.kernel_knobs(d)
        lib = kern.load_kernel()
        grid, per_sm = kern.grid_for(mesh.device, self.n_dev,
                                     shared=self.second_stream,
                                     wire_i8=bool(k["wire_i8"]))
        return f"moe_dispatch kernel {lib._name}: grid {grid} ({per_sm}/SM)"

    def build(self, d: Directive, mesh):
        if d.backend in ("PALLAS_RDMA", "HYBRID"):
            return self._make_kernel(mesh, d)
        return self._make(mesh, overlap=(d.placement == "STREAM_SPLIT"),
                          wire_i8=bool(d.tunable("wire_i8", 0)))

    def default_tunables(self):
        return {"tight": 1, "wire_i8": 0, "block_tokens": 64,
                "combine_tile": 64}

    # --------------------------------------------------------- l3 cost model
    def analytic_cost(self, d: Directive, hw) -> float:
        return self.cost_breakdown(d, hw).total

    def cost_breakdown(self, d: Directive, hw) -> CostBreakdown:
        Seg = CostSegment
        n, T, dm, f = self.n_dev, self.T, self.d, self.f
        counts = self._counts(T)
        C = int(counts.max())
        kernel = d.backend in ("PALLAS_RDMA", "HYBRID")
        k = self.kernel_knobs(d) if kernel else None
        tight = k["tight"] if kernel \
            else bool(d.granularity == "PER_PEER" and d.tunable("tight", 1))
        wire_i8 = bool(d.tunable("wire_i8", 0))
        bytes_per = 1 if wire_i8 else 2
        # the busiest expert rank (rank 0 under skew) bounds the step
        recv_tokens = int(counts[0]) * n if tight else C * n
        self_tokens = int(counts[0])
        flops = 3 * 2 * recv_tokens * dm * f          # GEMM1 (2f) + GEMM2
        t_comp = flops / hw.chip.peak_bf16_flops
        t_self = t_comp * self_tokens / max(1, recv_tokens)
        t_remote = t_comp - t_self
        # tight wire: exactly the off-rank tokens (counts.sum() - counts[0]);
        # padded wire: the max-capacity block to every peer (C * (n - 1))
        sent = (counts.sum() - counts[0]) if tight else C * (n - 1)
        t_disp = sent * dm * bytes_per / hw.chip.ici_link_bw
        t_comb = sent * dm * 2 / hw.chip.ici_link_bw  # combine in bf16
        t_quant = (2 * T * dm * 2 / hw.chip.hbm_bw) if wire_i8 else 0.0

        if kernel:
            # fused device-initiated kernel: one launch for the whole
            # quantize/dispatch/compute/combine chain; per-edge signal
            # semaphores instead of a global barrier; per-round DMA
            # issue/check overhead for the permutation schedule. The l3
            # target is real TPU hardware, where the interpreter's lockstep
            # dummy rounds are elided — charge the tighter executed
            # schedule, never the padded one.
            B = k["block_tokens"]
            sched = make_schedule(counts, B, k["tight"])
            disp_rounds = sched.issued_rounds(elide_dummy=True)
            # combine rounds are rank-dependent: the busiest expert (rank
            # 0) returns blocks[0] microblocks to every source
            ticks = sched.combine_ticks(k["combine_tile"], rank=0,
                                        elide_dummy=True) \
                if k["tile_fused"] \
                else sched.combine_issued_rounds(0, elide_dummy=True)
            if k["tile_fused"]:
                sync = 0.0       # readiness IS the per-tile ticks below
                # (SIGNAL and COUNTER build the identical fused kernel)
            elif d.completion == "BARRIER":
                sync = BARRIER_OVERHEAD
            else:
                sync = SIGNAL_OVERHEAD * max(1, n - 1)
            tail = (
                Seg("quant", t_quant, "quant"),
                Seg("sync", sync, "sync"),
                Seg("launch", KERNEL_LAUNCH, "launch"),
                Seg("tile_sync", (disp_rounds + ticks) * TILE_SYNC, "sync",
                    meta={"issued_rounds": disp_rounds, "ticks": ticks}),
            )
            if k["tile_fused"]:
                # FLUX credit: expert compute starts once the first
                # microblock lands, and the combine write of tile t hides
                # behind the GEMM of tile t+1 — only the final tile's
                # transfer stays exposed (per_tile_exposed_s), scaled by
                # the send-window recycle stall: a contexts-deep window
                # leaves ~1/contexts of a tile's wire unhidden while the
                # oldest send drains before the next tile may issue.
                startup = t_disp / max(1, disp_rounds)
                span = max(t_disp, startup + t_comp)
                window = window_stall_factor(k["contexts"])
                return CostBreakdown(segments=(
                    Seg("fused_span", span, "overlap",
                        meta={"wire_s": t_disp,
                              "compute_s": startup + t_comp}),
                    Seg("window_stall", window * per_tile_exposed_s(
                        sent * dm * 2, hw.chip.ici_link_bw, ticks), "stall",
                        meta={"contexts": k["contexts"]}),
                ) + tail, schedule=sched, knobs=k,
                    meta={"path": "kernel_tile_fused"})
            pipelined = (d.placement in ("TILE_PIPELINED", "STREAM_SPLIT")
                         and d.completion != "BARRIER" and d.contexts >= 2)
            if pipelined:
                # self-edge compute hides dispatch; per-peer compute hides
                # later arrivals; combine of peer p hides behind compute of
                # p+1 — only the last peer's chunks stay exposed.
                peers = max(1, n - 1)
                span = max(t_disp, t_self + t_remote * (peers - 1) / peers)
                return CostBreakdown(segments=(
                    Seg("pipeline_span", span, "overlap",
                        meta={"wire_s": t_disp,
                              "compute_s": t_self
                              + t_remote * (peers - 1) / peers}),
                    Seg("last_peer_compute", t_remote / peers, "compute"),
                    Seg("last_peer_combine", t_comb / peers, "wire"),
                ) + tail, schedule=sched, knobs=k,
                    meta={"path": "kernel_pipelined"})
            return CostBreakdown(segments=(
                Seg("dispatch", t_disp, "wire"),
                Seg("expert_ffn", t_comp, "compute"),
                Seg("combine", t_comb, "wire"),
            ) + tail, schedule=sched, knobs=k, meta={"path": "kernel_plain"})

        sync = BARRIER_OVERHEAD if d.completion == "BARRIER" else SIGNAL_OVERHEAD
        launches = KERNEL_LAUNCH * 4                  # quant/disp/comp/comb
        if d.placement == "STREAM_SPLIT":
            stage1 = max(t_disp + t_quant, t_self)    # dispatch hidden
            return CostBreakdown(segments=(
                Seg("dispatch_overlap", stage1, "overlap",
                    meta={"wire_s": t_disp + t_quant, "compute_s": t_self}),
                Seg("remote_ffn", t_remote, "compute"),
                Seg("combine", t_comb, "wire"),
                Seg("sync", sync, "sync"),
                Seg("launch", launches, "launch"),
            ), meta={"path": "xla_stream_split"})
        return CostBreakdown(segments=(
            Seg("quant", t_quant, "quant"),
            Seg("dispatch", t_disp, "wire"),
            Seg("expert_ffn", t_comp, "compute"),
            Seg("combine", t_comb, "wire"),
            Seg("sync", sync, "sync"),
            Seg("launch", launches, "launch"),
        ), meta={"path": "xla_host"})
