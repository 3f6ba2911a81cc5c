"""Workload 4: GEMM + AllGather (paper Appendix M; the minimal post-compute
collective). Port of ``repro/workloads/gemm_allgather.py``.

Every builder takes and returns the stacked rank layout: a (n, M_l, K)
with rank r's rows in row r, b (K, N) replicated, and returns
(n, n*M_l, N): every rank holds the whole gathered product.

* Host baseline: the local GEMMs, then one all-gather of the full output
  (``VirtualMesh.all_gather``) — sequential by data dependence.
* STREAM_SPLIT: the GEMM in ``chunks`` row chunks, chunk c gathered while
  chunk c+1 computes.
* PALLAS_RDMA / HYBRID: the hand-written Hopper kernel
  (``repro_torch.kernels.gemm_allgather``): TILE_FUSED broadcasts each
  tile as its GEMM ends (COUNTER: per-tile arrival ticks, the FLUX point),
  DEFERRED ships one whole slab per peer after the GEMM.

``kernel_knobs`` is the single directive→knob mapping both ``build()`` and
``cost_breakdown()`` consult; ``cost_breakdown`` is the reference's, line
for line, priced on whichever ``ChipSpec`` the context names.
"""
from __future__ import annotations

import torch

from repro_torch.core.cost_model import (CostBreakdown, CostSegment,
                                         per_tile_exposed_s,
                                         window_stall_factor)
from repro_torch.core.design_space import Directive
from repro_torch.core.schedule import (make_broadcast_schedule,
                                       sanitize_tile_m)
from repro_torch.workloads.base import (BARRIER_OVERHEAD, KERNEL_LAUNCH,
                                        SIGNAL_OVERHEAD, TILE_SYNC, Workload,
                                        inputs_from_numpy, register)

__all__ = ["GemmAllGather", "inputs_from_numpy"]


@register
class GemmAllGather(Workload):
    name = "gemm_allgather"
    ring_topology = False
    kernelizable = True           # repro_torch.kernels.gemm_allgather

    def __init__(self, n_dev=4, M=4096, K=4096, N=4096, axis="x"):
        self.n_dev = n_dev
        self.M = M
        self.K = K
        self.N = N
        self.axis = axis

    def example_inputs(self, seed, mesh, M_l=None):
        """Random inputs from ``seed`` on ``mesh.device`` at the
        reference's verification size (M_l 128, K and N at most 128); the
        tests use :func:`inputs_from_numpy` instead."""
        M_l = M_l or 128
        K, N = min(self.K, 128), min(self.N, 128)
        g = torch.Generator(device=mesh.device).manual_seed(int(seed))
        kw = dict(generator=g, device=mesh.device, dtype=torch.float32)
        return (torch.randn((self.n_dev, M_l, K), **kw),
                torch.randn((K, N), **kw))

    def reference(self, a, b):
        from repro_torch.kernels.ref import gemm_allgather_ref
        return gemm_allgather_ref(a, b)

    # ------------------------------------------- fault contract (core/faults)
    def degrade(self, live_ranks):
        """The global GEMM redistributes over the survivors: the local slab
        grows to ``ceil(M / n')`` rows (M rounds up to the new rank count —
        the broadcast schedule requires equal slabs)."""
        from repro_torch.core.schedule import check_live
        live = check_live(live_ranks, self.n_dev)
        if len(live) == self.n_dev:
            return self
        n = len(live)
        M_l = -(-self.M // n)
        return type(self)(n_dev=n, M=M_l * n, K=self.K, N=self.N,
                          axis=self.axis)

    def state_bytes_per_rank(self):
        # resident A slab + result slab (f32); B is replicated — survivors
        # already hold it, so a dead rank's copy needs no recovery wire
        M_l = self.M // self.n_dev
        return 4 * M_l * (self.K + self.N)

    # ------------------------------------------------------------- builders
    def host_baseline(self, mesh):
        def run(a, b):
            return mesh.all_gather(a @ b, tiled=True)

        return run

    def _stream_split(self, mesh, chunks):
        def run(a, b):
            M_l = a.shape[1]
            cs = max(1, M_l // chunks)
            outs = []
            for c0 in range(0, M_l, cs):
                c = a[:, c0:c0 + cs] @ b             # chunk c+1's GEMM is
                outs.append(mesh.all_gather(c, tiled=False))  # independent
            # (n, n, cs, N) chunks -> (n, n*M_l, N)
            full = torch.cat(outs, dim=2)
            return full.reshape(a.shape[0], -1, b.shape[1])

        return run

    # directive -> kernel-knob mapping shared by build() and analytic_cost()
    def kernel_knobs(self, d: Directive, M_l=None):
        k = super().kernel_knobs(d)      # tunables (raw) + contexts
        if M_l is None:
            M_l = self.M // self.n_dev   # the deployment slab (l3 model)
        k.update(
            # the TUNABLES grid need not divide a given local slab — the
            # kernel contract requires an exact divisor, so sanitize here
            tile_m=sanitize_tile_m(k["tile_m"], M_l),
            # BARRIER forces the deferred whole-slab drain even under a
            # TILE_FUSED placement (mirrors moe_dispatch.kernel_knobs)
            fused=(d.placement in ("TILE_FUSED", "TILE_PIPELINED")
                   and d.completion != "BARRIER"),
            # COUNTER = per-tile arrival ticks (the FLUX point); SIGNAL
            # keeps per-tile issue but waits once per inbound edge
            counter=d.completion == "COUNTER")
        return k

    def collective_schedule(self, d: Directive):
        # the deployment-slab broadcast schedule the kernel iterates —
        # l0 (core/verify.py) statically checks it ahead of l1 build
        if d.backend == "XLA_COLLECTIVE":
            return None
        k = self.kernel_knobs(d)
        return make_broadcast_schedule(self.n_dev, self.M // self.n_dev,
                                       k["tile_m"], k["fused"])

    def build(self, d: Directive, mesh):
        if d.backend == "XLA_COLLECTIVE":
            if d.placement == "STREAM_SPLIT":
                return self._stream_split(mesh, int(d.tunable("chunks", 4)))
            return self.host_baseline(mesh)
        from repro_torch.kernels.gemm_allgather import gemm_allgather

        def run(a, b):
            k = self.kernel_knobs(d, a.shape[1])
            return gemm_allgather(a, b, mesh, tile_m=k["tile_m"],
                                  fused=k["fused"], counter=k["counter"],
                                  contexts=k["contexts"])

        return run

    def load_kernels(self, d: Directive, mesh) -> str:
        if d.backend == "XLA_COLLECTIVE":
            return super().load_kernels(d, mesh)
        if mesh.device.type != "cuda":
            return "gemm_allgather plain version (cpu tensors)"
        from repro_torch.kernels import gemm_allgather as kern
        lib = kern.load_kernel()
        grid, per_sm = kern.grid_for(mesh.device, self.n_dev)
        return (f"gemm_allgather kernel {lib._name}: grid {grid} "
                f"({per_sm}/SM, {grid // self.n_dev} per rank)")

    def default_tunables(self):
        return {"tile_m": 128, "chunks": 4}

    # --------------------------------------------------------- l3 cost model
    def analytic_cost(self, d: Directive, hw) -> float:
        return self.cost_breakdown(d, hw).total

    def cost_breakdown(self, d: Directive, hw) -> CostBreakdown:
        Seg = CostSegment
        n = self.n_dev
        M_l = self.M // n
        t_gemm = 2.0 * M_l * self.K * self.N / hw.chip.peak_bf16_flops
        wire = (n - 1) * M_l * self.N * 2            # my slab to n-1 peers
        t_wire = wire / hw.chip.ici_link_bw
        sync = BARRIER_OVERHEAD if d.completion == "BARRIER" else SIGNAL_OVERHEAD
        if d.backend == "XLA_COLLECTIVE":
            if d.placement == "STREAM_SPLIT":
                chunks = max(1, int(d.tunable("chunks", 4)))
                per = t_gemm / chunks
                pw = t_wire / chunks
                # chunk c's gather overlaps chunk c+1's GEMM
                return CostBreakdown(segments=(
                    Seg("gemm_chunk0", per, "compute"),
                    Seg("gather_overlap",
                        max((chunks - 1) * per, (chunks - 1) * pw), "overlap",
                        meta={"compute_s": (chunks - 1) * per,
                              "wire_s": (chunks - 1) * pw, "chunks": chunks}),
                    Seg("gather_tail", pw, "wire"),
                    Seg("sync", sync, "sync"),
                    Seg("launch", KERNEL_LAUNCH * 2, "launch"),
                ), meta={"path": "xla_stream_split"})
            return CostBreakdown(segments=(
                Seg("gemm", t_gemm, "compute"),
                Seg("all_gather", t_wire, "wire"),
                Seg("sync", sync, "sync"),
                Seg("launch", KERNEL_LAUNCH * 2, "launch"),
            ), meta={"path": "xla_deferred"})

        # kernelized (PALLAS_RDMA / HYBRID): one fused launch; the schedule
        # charges TILE_SYNC per issued broadcast round and per completion
        # tick — same accounting shape as the moe_dispatch kernel model.
        k = self.kernel_knobs(d, M_l)
        sched = make_broadcast_schedule(n, M_l, k["tile_m"], k["fused"])
        ticks = sched.completion_ticks(k["counter"])
        if d.completion == "BARRIER":
            sync = BARRIER_OVERHEAD
        elif k["counter"]:
            sync = 0.0        # readiness IS the per-tile ticks below
        else:
            sync = SIGNAL_OVERHEAD * max(1, n - 1)
        tail = (
            Seg("sync", sync, "sync"),
            Seg("launch", KERNEL_LAUNCH, "launch"),
            Seg("tile_sync", (sched.issued_rounds() + ticks) * TILE_SYNC,
                "sync", meta={"issued_rounds": sched.issued_rounds(),
                              "ticks": ticks}),
        )
        if k["fused"]:
            # FLUX credit: tile t's broadcast hides behind tile t+1's GEMM
            # — only the final tile's transfer stays exposed
            # (per_tile_exposed_s over the per-tile issue granularity),
            # scaled by the send-window recycle stall: a contexts-deep
            # window leaves ~1/contexts of a tile's wire unhidden while
            # the oldest send drains before the next round may issue.
            per_gemm = t_gemm / max(1, sched.nt)
            span = max(t_gemm, per_gemm + t_wire)
            window = window_stall_factor(k["contexts"])
            return CostBreakdown(segments=(
                Seg("fused_span", span, "overlap",
                    meta={"compute_s": t_gemm, "wire_s": per_gemm + t_wire}),
                Seg("window_stall", window * per_tile_exposed_s(
                    wire, hw.chip.ici_link_bw, sched.issued_rounds()),
                    "stall", meta={"contexts": k["contexts"]}),
            ) + tail, schedule=sched, knobs=k, meta={"path": "kernel_fused"})
        # DEFERRED slab path: comm strictly after compute; the window
        # pipelines the per-peer slabs on the wire but the serial
        # dependence on the full GEMM remains.
        return CostBreakdown(segments=(
            Seg("gemm", t_gemm, "compute"),
            Seg("slab_broadcast", t_wire, "wire"),
        ) + tail, schedule=sched, knobs=k, meta={"path": "kernel_deferred"})
