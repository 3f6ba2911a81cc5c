"""Workload 3: KV-cache transfer for disaggregated prefill->decode serving
(paper Table 4 row 3, Appendix M). Port of ``repro/workloads/kv_transfer.py``.

Every builder takes and returns the stacked rank layout: x (2, T, d) with
the prefill rank's activations in row 0, wk/wv (d, dk) replicated, and
returns K, V each (2, T, dk) with the decode rank's copy in row 1 (row 0
zeros). The ``solo`` tier has one rank.

* Host baseline: the prefill rank computes K and V, then one bundled
  transfer (``VirtualMesh.ppermute``) moves both — the network idles
  during compute and compute idles during the transfer.
* STREAM_SPLIT: two independent permutes, K's issued before V's GEMM.
* PALLAS_RDMA / HYBRID: the hand-written Hopper shuttle
  (``repro_torch.kernels.kv_shuttle``) — chained, sequential, or the
  TILE_FUSED + COUNTER point (the FLUX point for the shuttle).

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
from repro_torch.core.schedule import make_ring_schedule
from repro_torch.workloads.base import (BARRIER_OVERHEAD, KERNEL_LAUNCH,
                                        SIGNAL_OVERHEAD, TILE_SYNC, Workload,
                                        inputs_from_numpy, register)

__all__ = ["KVTransfer", "inputs_from_numpy"]


def _decode_rank_only(t):
    """Zero every rank's row but the decode rank's (rank 1)."""
    keep = torch.arange(t.shape[0], device=t.device) == 1
    return torch.where(keep.view(-1, *([1] * (t.dim() - 1))), t,
                       torch.zeros((), dtype=t.dtype, device=t.device))


@register
class KVTransfer(Workload):
    name = "kv_transfer"
    ring_topology = False
    kernelizable = True           # repro_torch.kernels.kv_shuttle

    def __init__(self, T=4096, d=4096, dk=512, axis="x", solo=False):
        # ``solo``: the degraded single-tier fallback — one rank lost, the
        # survivor runs prefill and decode colocated, so the K/V projections
        # stay local and the shuttle disappears (degrade, don't hang)
        self.solo = bool(solo)
        self.n_dev = 1 if solo else 2
        self.T = T
        self.d = d
        self.dk = dk
        self.axis = axis

    def example_inputs(self, seed, mesh, T=None):
        """Random inputs from ``seed`` on ``mesh.device`` at the
        reference's verification size (T <= 128, d/8, dk/4); the tests use
        :func:`inputs_from_numpy` instead."""
        T = T or min(self.T, 128)
        g = torch.Generator(device=mesh.device).manual_seed(int(seed))
        kw = dict(generator=g, device=mesh.device, dtype=torch.float32)
        x_real = torch.randn((T, self.d // 8), **kw)
        x = x_real[None] if self.solo \
            else torch.stack([x_real, torch.zeros_like(x_real)])
        wk = torch.randn((self.d // 8, self.dk // 4), **kw)
        wv = torch.randn((self.d // 8, self.dk // 4), **kw)
        return x, wk, wv

    def reference(self, x, wk, wv):
        k = x[0] @ wk
        v = x[0] @ wv
        if self.solo:
            return k[None], v[None]
        return (torch.stack([torch.zeros_like(k), k]),
                torch.stack([torch.zeros_like(v), v]))

    # ------------------------------------------- fault contract (core/faults)
    def degrade(self, live_ranks):
        """Losing either tier collapses the disaggregation: the survivor
        serves prefill+decode colocated (the ``solo`` fallback)."""
        from repro_torch.core.schedule import check_live
        live = check_live(live_ranks, self.n_dev)
        if len(live) == self.n_dev:
            return self
        return type(self)(T=self.T, d=self.d, dk=self.dk, axis=self.axis,
                          solo=True)

    def state_bytes_per_rank(self):
        # prefill activations + the K/V cache of the handoff (f32)
        return 4 * (self.T * self.d + 2 * self.T * self.dk)

    # ------------------------------------------------------------- builders
    def host_baseline(self, mesh):
        if self.solo:
            return self._solo_local()

        def run(x, wk, wv):
            k = x @ wk                                   # every rank's GEMMs
            v = x @ wv
            kv = torch.cat([k, v], dim=-1)               # one bundled transfer
            kv = mesh.ppermute(kv, [(0, 1)])
            dk = k.shape[-1]
            return (_decode_rank_only(kv[..., :dk]),
                    _decode_rank_only(kv[..., dk:]))

        return run

    def _stream_split(self, mesh):
        def run(x, wk, wv):
            k = x @ wk
            k_sent = mesh.ppermute(k, [(0, 1)])          # K flies while ...
            v = x @ wv                                   # ... V computes
            v_sent = mesh.ppermute(v, [(0, 1)])
            return _decode_rank_only(k_sent), _decode_rank_only(v_sent)

        return run

    # directive -> kernel-knob mapping shared by build() and analytic_cost()
    def kernel_knobs(self, d: Directive):
        k = super().kernel_knobs(d)      # chained/kv_chunk (raw) + contexts
        fused = (d.placement == "TILE_FUSED" and d.completion != "BARRIER")
        # the K→V signal chain: placement decides the default (BARRIER
        # forces the conservative sequential shape), and the `chained`
        # tunable lets a diff patch flip it in place. None (the seeded
        # default) means "unset".
        ch = k["chained"]
        if ch is None:
            ch = (d.placement in ("STREAM_SPLIT", "TILE_PIPELINED",
                                  "TILE_FUSED")
                  and d.ordering != "ACQREL" and d.completion != "BARRIER")
        k.update(
            fused=fused,
            counter=(d.completion == "COUNTER" and fused),
            chained=bool(ch))
        return k

    def collective_schedule(self, d: Directive):
        # the degenerate 2-rank shuttle ring at the deployment tile count;
        # the solo tier moves nothing and verifies vacuously
        if d.backend == "XLA_COLLECTIVE" or self.n_dev < 2:
            return None
        k = self.kernel_knobs(d)
        return make_ring_schedule(2, self.T, k["kv_chunk"],
                                  fused=k["fused"])

    def _solo_local(self):
        # the single-tier fallback: both projections local, no collective
        def run(x, wk, wv):
            return (x[0] @ wk)[None], (x[0] @ wv)[None]

        return run

    def build(self, d: Directive, mesh):
        if self.solo:
            return self._solo_local()
        if d.backend == "XLA_COLLECTIVE":
            if d.placement == "STREAM_SPLIT":
                return self._stream_split(mesh)
            return self.host_baseline(mesh)
        from repro_torch.kernels.kv_shuttle import kv_shuttle
        k = self.kernel_knobs(d)

        def run(x, wk, wv):
            return kv_shuttle(x, wk, wv, chained=k["chained"],
                              fused=k["fused"], counter=k["counter"],
                              kv_chunk=k["kv_chunk"], contexts=k["contexts"])

        return run

    def load_kernels(self, d: Directive, mesh) -> str:
        if self.solo or d.backend == "XLA_COLLECTIVE":
            return super().load_kernels(d, mesh)
        if mesh.device.type != "cuda":
            return "kv_shuttle plain version (cpu tensors)"
        from repro_torch.kernels import kv_shuttle as kern
        lib = kern.load_kernel()
        grid, per_sm = kern.grid_for(mesh.device)
        return f"kv_shuttle kernel {lib._name}: grid {grid} ({per_sm}/SM)"

    def default_tunables(self):
        return {"chained": None, "kv_chunk": 64}

    # --------------------------------------------------------- l3 cost model
    def analytic_cost(self, d: Directive, hw) -> float:
        return self.cost_breakdown(d, hw).total

    def cost_breakdown(self, d: Directive, hw) -> CostBreakdown:
        Seg = CostSegment
        T, dd, dk = self.T, self.d, self.dk
        t_gemm = 2.0 * T * dd * dk / hw.chip.peak_bf16_flops
        t_send = T * dk * 2 / hw.chip.ici_link_bw
        if self.solo:
            return CostBreakdown(segments=(
                Seg("kv_gemms", 2 * t_gemm, "compute"),
                Seg("launch", KERNEL_LAUNCH, "launch"),
            ), meta={"path": "solo"})
        sync = BARRIER_OVERHEAD if d.completion == "BARRIER" else SIGNAL_OVERHEAD
        if d.backend == "XLA_COLLECTIVE":
            if d.placement == "STREAM_SPLIT":
                # K send overlaps V GEMM; V send exposed
                return CostBreakdown(segments=(
                    Seg("k_gemm", t_gemm, "compute"),
                    Seg("k_send_overlap", max(t_send, t_gemm), "overlap",
                        meta={"wire_s": t_send, "compute_s": t_gemm}),
                    Seg("v_send", t_send, "wire"),
                    Seg("sync", sync, "sync"),
                    Seg("launch", 2 * KERNEL_LAUNCH, "launch"),
                ), meta={"path": "xla_stream_split"})
            # bundled: both GEMMs then one 2x transfer
            return CostBreakdown(segments=(
                Seg("kv_gemms", 2 * t_gemm, "compute"),
                Seg("kv_send", 2 * t_send, "wire"),
                Seg("sync", sync, "sync"),
                Seg("launch", 2 * KERNEL_LAUNCH, "launch"),
            ), meta={"path": "xla_host"})
        k = self.kernel_knobs(d)
        if k["fused"]:
            # shuttle FLUX credit: tile c's send hides behind tile c+1's
            # GEMM; only the startup tile and the final exposed tail stay
            # serial. TILE_SYNC per issued round and per tick.
            sched = make_ring_schedule(2, T, k["kv_chunk"], fused=True)
            startup = 2 * t_gemm / sched.nc
            span = max(2 * t_gemm, startup + 2 * t_send)
            exposed = window_stall_factor(k["contexts"]) \
                * per_tile_exposed_s(2 * T * dk * 2, hw.chip.ici_link_bw,
                                     sched.nc)
            fixed = (sched.issued_rounds()
                     + sched.completion_ticks(k["counter"])) * TILE_SYNC
            return CostBreakdown(segments=(
                Seg("fused_span", span, "overlap",
                    meta={"compute_s": 2 * t_gemm,
                          "wire_s": startup + 2 * t_send}),
                Seg("window_stall", exposed, "stall",
                    meta={"contexts": k["contexts"]}),
                Seg("tile_sync", fixed, "sync",
                    meta={"issued_rounds": sched.issued_rounds(),
                          "ticks": sched.completion_ticks(k["counter"])}),
                Seg("launch", KERNEL_LAUNCH, "launch"),
            ), schedule=sched, knobs=k, meta={"path": "kernel_fused"})
        if k["chained"]:
            return CostBreakdown(segments=(
                Seg("k_gemm", t_gemm, "compute"),
                Seg("k_send_overlap", max(t_send, t_gemm), "overlap",
                    meta={"wire_s": t_send, "compute_s": t_gemm}),
                Seg("v_send", t_send, "wire"),
                Seg("sync", sync, "sync"),
                Seg("launch", KERNEL_LAUNCH, "launch"),
            ), knobs=k, meta={"path": "kernel_chained"})
        return CostBreakdown(segments=(
            Seg("kv_gemms", 2 * t_gemm, "compute"),
            Seg("kv_send", 2 * t_send, "wire"),
            Seg("sync", sync, "sync"),
            Seg("launch", KERNEL_LAUNCH, "launch"),
        ), knobs=k, meta={"path": "kernel_deferred"})
