"""Workload 1: Flash Attention with Context Parallelism (ring attention).
Port of ``repro/workloads/ring_attention.py``.

Every builder takes and returns the stacked rank layout: q/k/v
(n, BH, Sl, hd), rank r holding rows ``[r*Sl, (r+1)*Sl)`` of one causal
sequence.

* Host baseline: n rounds, each attending to the held KV shard and then
  rotating it one hop with ``VirtualMesh.ppermute`` — the round's permute
  comes after its compute (data dependence: exchange / compute / …).
* STREAM_SPLIT: the same rounds with the rotation issued first, free of
  the round's compute.
* PALLAS_RDMA / HYBRID: the hand-written Hopper ring kernel
  (``repro_torch.kernels.ring_attention``): DEFERRED rotates whole shards
  and fences eagerly, TILE_PIPELINED fences after the round's compute
  (lazy fence), TILE_FUSED + COUNTER (the FLUX point for rings) rotates
  ``kv_chunk``-row chunks with per-chunk arrival ticks.

``kernel_knobs`` is the single directive→knob mapping both ``build()`` and
``cost_breakdown()`` consult; ``cost_breakdown`` is the reference's, line
for line, priced on whichever ``ChipSpec`` the context names.

Full deployment shape (paper §4.2): 4 devices, SEQ in {4096, 8192},
HD in {32, 64}, GPT-2-ish multi-head layout.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.cost_model import (CostBreakdown, CostSegment,
                                         per_tile_exposed_s,
                                         window_stall_factor)
from repro_torch.core.design_space import Directive
from repro_torch.core.schedule import make_ring_schedule
from repro_torch.workloads.base import (BARRIER_OVERHEAD, KERNEL_LAUNCH,
                                        SIGNAL_OVERHEAD, TILE_SYNC, Workload,
                                        inputs_from_numpy, register)

__all__ = ["RingAttention", "inputs_from_numpy"]


@register
class RingAttention(Workload):
    name = "ring_attention"
    ring_topology = True
    kernelizable = True           # repro_torch.kernels.ring_attention

    def __init__(self, n_dev=4, BH=8, seq=4096, hd=64, axis="x"):
        self.n_dev = n_dev
        self.BH = BH
        self.seq = seq
        self.hd = hd
        self.sl = seq // n_dev
        self.axis = axis

    def example_inputs(self, seed, mesh, sl=None):
        """Random q, k, v from ``seed`` on ``mesh.device`` at the
        reference's verification size (sl at most 128); the tests use
        :func:`inputs_from_numpy` instead."""
        sl = sl or min(self.sl, 128)
        g = torch.Generator(device=mesh.device).manual_seed(int(seed))
        shape = (self.n_dev, self.BH, sl, self.hd)
        return tuple(torch.randn(shape, generator=g, device=mesh.device,
                                 dtype=torch.float32) for _ in range(3))

    def reference(self, q, k, v):
        from repro_torch.kernels.ref import ring_attention_ref
        return ring_attention_ref(q, k, v, causal=True)

    # ------------------------------------------- fault contract (core/faults)
    def degrade(self, live_ranks):
        """The global sequence re-shards over the survivors: the local KV
        shard grows to ``ceil(seq / n')`` rows (seq rounds up to the new
        rank count — the rotation requires equal shards)."""
        from repro_torch.core.schedule import check_live
        live = check_live(live_ranks, self.n_dev)
        if len(live) == self.n_dev:
            return self
        n = len(live)
        sl = -(-self.seq // n)
        return type(self)(n_dev=n, BH=self.BH, seq=sl * n, hd=self.hd,
                          axis=self.axis)

    def state_bytes_per_rank(self):
        # resident Q/K/V shards (f32)
        return 4 * 3 * self.BH * self.sl * self.hd

    # ------------------------------------------------------------- builders
    def _rounds(self, mesh, permute_first):
        """n attention rounds over the rotating KV shards. ``permute_first``
        issues each round's rotation before its compute (STREAM_SPLIT);
        otherwise it follows the compute (the host baseline)."""
        n = self.n_dev
        perm = [(i, (i + 1) % n) for i in range(n)]

        def run(q, k, v):
            sl = q.shape[2]
            ranks = torch.arange(n, device=q.device)
            qpos = (ranks[:, None] * sl
                    + torch.arange(sl, device=q.device))[:, None, :, None]
            m = torch.full(q.shape[:3], -1e30, dtype=q.dtype, device=q.device)
            l = torch.zeros(q.shape[:3], dtype=q.dtype, device=q.device)
            acc = torch.zeros_like(q)
            k_c, v_c = k, v
            for r in range(n):
                if permute_first:
                    k_n = mesh.ppermute(k_c, perm)
                    v_n = mesh.ppermute(v_c, perm)
                kpos = (((ranks - r) % n)[:, None] * sl
                        + torch.arange(sl, device=q.device))[:, None, None, :]
                s = torch.einsum("nbqd,nbkd->nbqk", q, k_c) \
                    / math.sqrt(self.hd)
                s = torch.where(qpos >= kpos, s, torch.full_like(s, -1e30))
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] \
                    + torch.einsum("nbqk,nbkd->nbqd", p, v_c)
                m = m_new
                if not permute_first:
                    # host-driven: the next round's KV arrives only after
                    # this round's compute (data dependence = sequential)
                    k_n = mesh.ppermute(k_c, perm)
                    v_n = mesh.ppermute(v_c, perm)
                k_c, v_c = k_n, v_n
            return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

        return run

    def host_baseline(self, mesh):
        """Sequential rounds with a collective-permute between them."""
        return self._rounds(mesh, permute_first=False)

    def _stream_split(self, mesh):
        """Overlap at graph level: the permute for round r+1 is issued
        before round r's compute and carries no dependence on it."""
        return self._rounds(mesh, permute_first=True)

    # directive -> kernel-knob mapping shared by build() and analytic_cost()
    def kernel_knobs(self, d: Directive):
        k = super().kernel_knobs(d)      # kv_chunk (raw) + contexts
        fused = (d.placement == "TILE_FUSED" and d.completion != "BARRIER")
        k.update(
            # chunk-major rotation rounds (the FLUX-ring path); BARRIER
            # forces the whole-shard eager drain even under TILE_FUSED
            fused=fused,
            # COUNTER = per-chunk arrival ticks; SIGNAL drains a step's
            # chunks up front (per-edge wait, chunked issue)
            counter=(d.completion == "COUNTER" and fused),
            # lazy fence: the whole-shard rotation overlaps the round's
            # compute; ACQREL orders the fence eagerly, and BARRIER's
            # global-rendezvous semantics force the same serialized drain
            pipelined=d.placement in ("TILE_PIPELINED", "TILE_FUSED"),
            eager=((d.ordering == "ACQREL" or d.completion == "BARRIER")
                   and not fused))
        return k

    def collective_schedule(self, d: Directive):
        # the deployment-shard rotation schedule the ring kernel runs —
        # l0 (core/verify.py) statically checks it ahead of l1 build
        if d.backend == "XLA_COLLECTIVE":
            return None
        k = self.kernel_knobs(d)
        return make_ring_schedule(self.n_dev, self.sl, k["kv_chunk"],
                                  fused=k["fused"])

    def build(self, d: Directive, mesh):
        if d.backend == "XLA_COLLECTIVE":
            if d.placement == "STREAM_SPLIT":
                return self._stream_split(mesh)
            return self.host_baseline(mesh)
        from repro_torch.kernels.ring_attention import ring_attention
        k = self.kernel_knobs(d)

        def run(q, k_in, v_in):
            return ring_attention(q, k_in, v_in, mesh, causal=True,
                                  fused=k["fused"], counter=k["counter"],
                                  kv_chunk=k["kv_chunk"],
                                  pipelined=k["pipelined"],
                                  eager_wait=k["eager"],
                                  contexts=k["contexts"])

        return run

    def load_kernels(self, d: Directive, mesh) -> str:
        if d.backend == "XLA_COLLECTIVE":
            return super().load_kernels(d, mesh)
        if mesh.device.type != "cuda":
            return "ring_attention plain version (cpu tensors)"
        from repro_torch.kernels import ring_attention as kern
        lib = kern.load_kernel()
        grid, per_sm = kern.grid_for(mesh.device, self.n_dev, self.hd)
        ctas = kern.ring_ctas(grid, self.n_dev, self.BH, self.sl)
        return (f"ring_attention kernel {lib._name}: grid {grid} "
                f"({per_sm}/SM; per rank {ctas})")

    def default_tunables(self):
        # kv_chunk joins the TUNABLES grid: slow-path diff patches refine
        # the rotation chunk rows of the kernelized ring points
        return {"kv_chunk": 64}

    # --------------------------------------------------------- l3 cost model
    def analytic_cost(self, d: Directive, hw) -> float:
        return self.cost_breakdown(d, hw).total

    def cost_breakdown(self, d: Directive, hw) -> CostBreakdown:
        Seg = CostSegment
        n, BH, sl, hd = self.n_dev, self.BH, self.sl, self.hd
        flops_round = 4.0 * BH * sl * sl * hd          # qk^T + pv (causal ~1/2
        flops_round *= 0.5 * (1 + 1.0 / n)             # avg causal occupancy)
        t_comp = flops_round / hw.chip.peak_bf16_flops
        wire_round = 2 * BH * sl * hd * 2              # K and V, bf16
        t_wire = wire_round / hw.chip.ici_link_bw
        sync = BARRIER_OVERHEAD if d.completion == "BARRIER" else SIGNAL_OVERHEAD
        if d.backend == "XLA_COLLECTIVE":
            if d.placement == "STREAM_SPLIT":
                per_round = max(t_comp, t_wire) + sync
                kind, path = "overlap", "xla_stream_split"
            else:
                per_round = t_comp + t_wire + sync + KERNEL_LAUNCH
                kind, path = "compute", "xla_host"
            return CostBreakdown(segments=(
                Seg("ring_rounds", n * per_round, kind,
                    meta={"rounds": n, "per_round_s": per_round,
                          "compute_s": t_comp, "wire_s": t_wire}),
                Seg("launch", KERNEL_LAUNCH * n, "launch",
                    meta={"launches": n}),     # per-round host launches
            ), meta={"path": path})
        # device-initiated: no host launches inside the ring
        k = self.kernel_knobs(d)
        if k["fused"]:
            # FLUX-ring credit: chunk c's rotation hides behind chunk c+1's
            # attention compute; per rotation step only the final chunk's
            # wire stays exposed (per_tile_exposed_s over the chunk count),
            # scaled by the send-window recycle stall. The schedule charges
            # TILE_SYNC per issued round and per completion tick.
            sched = make_ring_schedule(n, sl, k["kv_chunk"], fused=True)
            per_round = max(t_comp, t_wire)
            exposed = window_stall_factor(k["contexts"]) \
                * per_tile_exposed_s(wire_round, hw.chip.ici_link_bw,
                                     sched.nc)
            fixed = (sched.issued_rounds()
                     + sched.completion_ticks(k["counter"])) * TILE_SYNC
            return CostBreakdown(segments=(
                Seg("ring_rounds", sched.steps * per_round, "overlap",
                    meta={"rounds": sched.steps, "per_round_s": per_round,
                          "compute_s": t_comp, "wire_s": t_wire}),
                Seg("window_stall", sched.steps * exposed, "stall",
                    meta={"contexts": k["contexts"]}),
                Seg("final_compute", t_comp, "compute"),
                Seg("tile_sync", fixed, "sync",
                    meta={"issued_rounds": sched.issued_rounds(),
                          "ticks": sched.completion_ticks(k["counter"])}),
                Seg("launch", KERNEL_LAUNCH, "launch"),
            ), schedule=sched, knobs=k, meta={"path": "kernel_fused"})
        if k["pipelined"] and not k["eager"]:
            per_round = max(t_comp, t_wire) + sync     # lazy fence overlap
            kind, path = "overlap", "kernel_pipelined"
        else:                                          # DEFERRED / ACQREL
            per_round = t_comp + t_wire + sync
            kind, path = "compute", "kernel_deferred"
        return CostBreakdown(segments=(
            Seg("ring_rounds", n * per_round, kind,
                meta={"rounds": n, "per_round_s": per_round,
                      "compute_s": t_comp, "wire_s": t_wire}),
            Seg("launch", KERNEL_LAUNCH, "launch"),   # one cooperative launch
        ), knobs=k, meta={"path": path})
