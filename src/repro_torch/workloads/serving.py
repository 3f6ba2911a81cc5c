"""Workload 5: the serving decode step — a DeepSeek-V3-style MoE layer at
serving shapes (one routed expert per rank + a replicated shared expert),
the executable home of the paper's headline two-stream discovery.

The step is ``MoEDispatch``'s quantize → dispatch → routed-expert FFN →
combine chain *plus* the shared-expert FFN every token takes. That shared
GEMM is the compute the serving loop must do anyway and it has no data
dependence on the dispatch wire — exactly TokenWeave's shape: overlap the
communication with compute you already owe.

Realizations (all semantics-preserving, cascade l2 checks):

* host (``CONSERVATIVE``) — strictly sequential: quantize, dispatch,
  routed FFN, combine, shared FFN.
* ``TokenWeave`` (XLA STREAM_SPLIT) — the shared-expert + self-chunk FFNs
  are issued with no dependence on the dispatch all-to-all (in the port,
  a plain torch build on the virtual mesh).
* DeepEP / FLUX (PALLAS_RDMA) — the fused ``kernels/moe_dispatch`` kernel
  with the shared-expert FFN as its **second stream**: issued inside the
  kernel against the open dispatch send window (after the last dispatch
  store is issued); on the Hopper kernel it is a CTA partition of the
  same launch that runs while the dispatch stores are in flight.

Default shape: 4 ranks × 256 decode tokens, d=7168, f=2048 per expert and
for the shared expert (the DeepSeek-V3 decode-layer proportions); routing
uniform (``skew=1.0``) — a continuous decode batch mixes many users, so
per-expert load evens out relative to the prefill-time skew law.

Port of ``repro/workloads/serving.py``; ``cost_breakdown`` is the
reference's, line for line.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import telemetry
from repro_torch.core.cost_model import (CostBreakdown, CostSegment,
                                         per_tile_exposed_s,
                                         window_stall_factor)
from repro_torch.core.design_space import Directive
from repro_torch.kernels.moe_dispatch import make_schedule, swiglu_ffn
from repro_torch.workloads.base import (BARRIER_OVERHEAD, KERNEL_LAUNCH,
                                        SIGNAL_OVERHEAD, TILE_SYNC, register)
from repro_torch.workloads.moe_dispatch import MoEDispatch


@register
class ServingStep(MoEDispatch):
    name = "serving_step"
    ring_topology = False
    kernelizable = True
    second_stream = True          # the shared-expert FFN rides the kernel
    # collective_schedule is inherited from MoEDispatch: the serving step
    # issues the same dispatch/combine permutation at its decode token
    # count, so l0 static verification covers the serving tier through
    # the same seam

    def __init__(self, n_dev=4, tokens_per_rank=256, d=7168, f=2048,
                 f_shared=2048, skew=1.0, axis="x", route_weights=None):
        super().__init__(n_dev=n_dev, tokens_per_rank=tokens_per_rank,
                         d=d, f=f, skew=skew, axis=axis,
                         route_weights=route_weights)
        self.f_shared = f_shared

    def degrade(self, live_ranks, capacity_factor=1.25):
        w = super().degrade(live_ranks, capacity_factor)
        if w is not self:
            w.f_shared = self.f_shared
        return w

    def state_bytes_per_rank(self):
        return super().state_bytes_per_rank() + 4 * (
            self.d * 2 * self.f_shared + self.f_shared * self.d)

    # ------------------------------------------------------------- inputs
    def example_inputs(self, seed, mesh, T=None):
        x, w1, w2 = super().example_inputs(seed, mesh, T=T)
        g = torch.Generator(device=mesh.device).manual_seed(int(seed) + 7)
        kw = dict(generator=g, device=mesh.device, dtype=torch.float32)
        s1 = torch.randn((self.d, 2 * self.f_shared), **kw) \
            / math.sqrt(self.d)
        s2 = torch.randn((self.f_shared, self.d), **kw) \
            / math.sqrt(self.f_shared)
        return x, w1, w2, s1, s2

    def _shared(self, x, s1, s2):
        return swiglu_ffn(x, s1, s2)

    def reference(self, x, w1, w2, s1, s2):
        return super().reference(x, w1, w2) + self._shared(x, s1, s2)

    # ------------------------------------------------------------ builders
    def _make(self, mesh, *, overlap, wire_i8):
        routed = MoEDispatch._make(self, mesh, overlap=overlap,
                                   wire_i8=wire_i8)

        def run(x, w1, w2, s1, s2):
            # the shared FFN has no dependence on the dispatch wire: under
            # STREAM_SPLIT it may run while the all-to-all is in flight —
            # the TokenWeave point
            return routed(x, w1, w2) + self._shared(x, s1, s2)

        return run

    def _make_kernel(self, mesh, d: Directive):
        from repro_torch.kernels.moe_dispatch import moe_dispatch_combine
        k = self.kernel_knobs(d)

        def run(x, w1, w2, s1, s2):
            y, ys = moe_dispatch_combine(
                x, w1, w2, counts=self._counts(x.shape[1]),
                block_tokens=k["block_tokens"], tight=k["tight"],
                pipelined=k["pipelined"], barrier=k["barrier"],
                tile_fused=k["tile_fused"], combine_tile=k["combine_tile"],
                wire_i8=bool(k["wire_i8"]), shared=(x, s1, s2),
                contexts=k["contexts"])
            with telemetry.span("serving.shared_add"):
                return y + ys

        return run

    # --------------------------------------------------------- l3 cost model
    def cost_breakdown(self, d: Directive, hw) -> CostBreakdown:
        Seg = CostSegment
        n, T, dm, f, fs = self.n_dev, self.T, self.d, self.f, self.f_shared
        counts = self._counts(T)
        C = int(counts.max())
        kernel = d.backend in ("PALLAS_RDMA", "HYBRID")
        k = self.kernel_knobs(d) if kernel else None
        tight = k["tight"] if kernel \
            else bool(d.granularity == "PER_PEER" and d.tunable("tight", 1))
        wire_i8 = bool(d.tunable("wire_i8", 0))
        bytes_per = 1 if wire_i8 else 2
        recv_tokens = int(counts[0]) * n if tight else C * n
        self_tokens = int(counts[0])
        t_routed = 3 * 2 * recv_tokens * dm * f / hw.chip.peak_bf16_flops
        t_self = t_routed * self_tokens / max(1, recv_tokens)
        t_remote = t_routed - t_self
        t_shared = 3 * 2 * T * dm * fs / hw.chip.peak_bf16_flops
        sent = (counts.sum() - counts[0]) if tight else C * (n - 1)
        t_disp = sent * dm * bytes_per / hw.chip.ici_link_bw
        t_comb = sent * dm * 2 / hw.chip.ici_link_bw
        t_quant = (2 * T * dm * 2 / hw.chip.hbm_bw) if wire_i8 else 0.0

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
            tail = (
                Seg("quant", t_quant, "quant"),
                Seg("sync", sync, "sync"),
                Seg("launch", KERNEL_LAUNCH, "launch"),
                Seg("tile_sync", (disp_rounds + ticks) * TILE_SYNC, "sync",
                    meta={"issued_rounds": disp_rounds, "ticks": ticks}),
            )
            if k["tile_fused"]:
                # FLUX + second stream: the compute track runs shared FFN
                # (issued against the open send window) then the tiled
                # routed FFN as arrivals land; the wire track is dispatch.
                startup = t_disp / max(1, disp_rounds)
                span = max(t_disp, startup + t_shared + t_routed)
                window = window_stall_factor(k["contexts"])
                return CostBreakdown(segments=(
                    Seg("two_stream_span", span, "overlap",
                        meta={"wire_s": t_disp,
                              "compute_s": startup + t_shared + t_routed}),
                    Seg("window_stall", window * per_tile_exposed_s(
                        sent * dm * 2, hw.chip.ici_link_bw, ticks), "stall",
                        meta={"contexts": k["contexts"]}),
                ) + tail, schedule=sched, knobs=k,
                    meta={"path": "kernel_two_stream"})
            # DeepEP-style deferred/pipelined: the shared FFN still issues
            # against the open dispatch window (the kernel runs it between
            # the last push and the drain on every completion path)
            return CostBreakdown(segments=(
                Seg("two_stream", max(t_disp, t_shared), "overlap",
                    meta={"wire_s": t_disp, "compute_s": t_shared}),
                Seg("expert_ffn", t_routed, "compute"),
                Seg("combine", t_comb, "wire"),
            ) + tail, schedule=sched, knobs=k,
                meta={"path": "kernel_deferred_two_stream"})

        sync = BARRIER_OVERHEAD if d.completion == "BARRIER" \
            else SIGNAL_OVERHEAD
        launches = KERNEL_LAUNCH * 5              # + the shared-expert GEMM
        if d.placement == "STREAM_SPLIT":
            # TokenWeave: dispatch hidden behind shared + self-chunk FFNs
            stage1 = max(t_disp + t_quant, t_shared + t_self)
            return CostBreakdown(segments=(
                Seg("two_stream", stage1, "overlap",
                    meta={"wire_s": t_disp + t_quant,
                          "compute_s": t_shared + t_self}),
                Seg("remote_ffn", t_remote, "compute"),
                Seg("combine", t_comb, "wire"),
                Seg("sync", sync, "sync"),
                Seg("launch", launches, "launch"),
            ), meta={"path": "xla_two_stream"})
        return CostBreakdown(segments=(
            Seg("quant", t_quant, "quant"),
            Seg("dispatch", t_disp, "wire"),
            Seg("expert_ffn", t_routed, "compute"),
            Seg("combine", t_comb, "wire"),
            Seg("shared_ffn", t_shared, "compute"),
            Seg("sync", sync, "sync"),
            Seg("launch", launches, "launch"),
        ), meta={"path": "xla_host"})
