"""Paper Table 5: per-phase latency of the MoE layer — expert-library-style
sequential flow vs CUCo two-stream split vs the device-initiated kernel
(DeepEP point: tight wire, one fused launch, per-edge signals). Phases:
quantize / dispatch / compute / combine (port of
``benchmarks/table5_moe_phases.py``).

With ``measure`` the four totals run at the table's shape (2 ranks, 6144
tokens a rank, d 7168, f 2048, skew 2, f32 on an int8 wire): the
sequential flow and the two-stream split as plain torch over a
``VirtualMesh``, the DeepEP and FLUX points through ``moe_dispatch.cu``,
each held to ``reference()`` within 0.1 (the int8 wire). Each measured
total is held against the H100 model of its own row: the table's phase
formula for the sequential flow and the split, the l3 model for the two
kernels. The phases are a model of the parts of one call and stay
modeled. The ranks are partitions of one card: a measured delta is one
card holding both.

    PYTHONPATH=src python -m repro_torch.figures.table5_moe_phases \
        --device cuda [--chip h100|v5e] [--out PATH]
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import common
from repro_torch.workloads import get_workload
from repro_torch.workloads.base import KERNEL_LAUNCH

SHAPE = dict(n_dev=2, tokens_per_rank=6144, d=7168, f=2048, skew=2.0)
POINT_NAMES = ("sequential_total_ms", "cuco_total_ms",
               "deepep_kernel_total_ms", "flux_kernel_total_ms")


def points():
    """The directive each measured total runs: the sequential flow and the
    two-stream split on the int8 wire, the DeepEP and FLUX kernels."""
    seq = Directive("XLA_COLLECTIVE", placement="DEFERRED",
                    granularity="PER_CHUNK", tunables=(("wire_i8", 1),))
    cuco = Directive("XLA_COLLECTIVE", placement="STREAM_SPLIT",
                     granularity="PER_PEER",
                     tunables=(("tight", 1), ("wire_i8", 1)))
    deepep = Directive("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", "LOCAL",
                       "GRID_STEP", "PER_PEER", "ACQUIRE", 2,
                       tunables=(("tight", 1), ("wire_i8", 1)))
    flux = EXPERT_SYSTEMS["FLUX"].with_tunable("wire_i8", 1)
    return dict(zip(POINT_NAMES, (seq, cuco, deepep, flux)))


def phases(w, hw):
    """The table's terms on ``hw``, in ms (the kernels' totals in us, as
    the reference's rows hold them); rank 0 is the busiest."""
    counts = w._counts(w.T)
    C = int(counts.max())
    n = w.n_dev
    chip = hw.chip
    recv = C * n
    p = dict(t_comp=3 * 2 * recv * w.d * w.f / chip.peak_bf16_flops * 1e3)
    p["t_self"] = p["t_comp"] * counts[0] / recv
    p["t_remote"] = p["t_comp"] - p["t_self"]
    p["sent"] = sent = C * (n - 1)
    p["t_disp"] = sent * w.d * 1 / chip.ici_link_bw * 1e3      # int8 wire
    p["t_comb"] = sent * w.d * 2 / chip.ici_link_bw * 1e3
    p["t_quant"] = 2 * w.T * w.d * 2 / chip.hbm_bw * 1e3
    p["seq_total"] = p["t_quant"] + p["t_disp"] + p["t_comp"] \
        + p["t_comb"] + 4 * KERNEL_LAUNCH * 1e3
    p["over_total"] = max(p["t_disp"] + p["t_quant"], p["t_self"]) \
        + p["t_remote"] + p["t_comb"] + 4 * KERNEL_LAUNCH * 1e3
    # device-initiated tight dispatch (the DeepEP analogue, one fused launch)
    p["tight"] = tight = int(counts.sum() - counts[0])
    p["t_disp_t"] = tight * w.d * 1 / chip.ici_link_bw * 1e3
    p["t_comb_t"] = tight * w.d * 2 / chip.ici_link_bw * 1e3
    pts = points()
    p["deepep_total"] = w.analytic_cost(pts["deepep_kernel_total_ms"],
                                        hw) * 1e6
    # FLUX point: tile-fused expert GEMM, per-tile combine, int8 wire
    p["flux_total"] = w.analytic_cost(pts["flux_kernel_total_ms"], hw) * 1e6
    return p


def totals_us(p):
    """The four totals of :func:`phases` ``p`` in us, by row name."""
    return {"table5/sequential_total_ms": p["seq_total"] * 1e3,
            "table5/cuco_total_ms": p["over_total"] * 1e3,
            "table5/deepep_kernel_total_ms": p["deepep_total"],
            "table5/flux_kernel_total_ms": p["flux_total"]}


def run(device="cuda", *, chip=H100, mesh=None, measure=True, small=False,
        iters=5, out=None):
    device = common.resolve_device(device)
    hw = extract_hardware_context(mesh or VirtualMesh(1, device=device),
                                  chip)
    w = get_workload("moe_dispatch", **SHAPE)
    p = phases(w, hw)
    seq_total, over_total = p["seq_total"], p["over_total"]
    t_self, t_disp = p["t_self"], p["t_disp"]
    deepep_total, flux_total = p["deepep_total"], p["flux_total"]
    tot = totals_us(p)
    rows = [
        ("table5/quantize_ms", p["t_quant"] * 1e3, ""),
        ("table5/dispatch_ms", t_disp * 1e3, "hidden behind self-compute "
         f"({t_self:.3f} ms) in CUCo" if t_self > t_disp else "exposed"),
        ("table5/compute_ms", p["t_comp"] * 1e3, f"self={t_self:.3f}ms "
         f"remote={p['t_remote']:.3f}ms"),
        ("table5/combine_ms", p["t_comb"] * 1e3, ""),
        ("table5/dispatch_tight_ms", p["t_disp_t"] * 1e3,
         f"device-initiated per-peer wire: {p['tight']} vs {p['sent']} tok "
         "padded"),
        ("table5/combine_tight_ms", p["t_comb_t"] * 1e3, ""),
        ("table5/sequential_total_ms", tot["table5/sequential_total_ms"],
         "DeepEP-style"),
        ("table5/cuco_total_ms", tot["table5/cuco_total_ms"],
         f"delta={(seq_total - over_total) / seq_total * 100:.1f}% "
         "(paper: -12.4%)"),
        ("table5/deepep_kernel_total_ms", deepep_total,
         f"delta={(seq_total - deepep_total / 1e3) / seq_total * 100:.1f}% "
         "vs sequential (tight wire + 1 launch + signal)"),
        ("table5/flux_kernel_total_ms", flux_total,
         f"delta={(seq_total - flux_total / 1e3) / seq_total * 100:.1f}% "
         "vs sequential (tile-fused GEMM + per-tile combine)"),
    ]
    card = common.measured_rows(
        "moe_dispatch", SHAPE,
        [("table5/" + name, d) for name, d in points().items()], hw,
        device=device, small=small, iters=iters,
        h100_us=totals_us(phases(w, dataclasses.replace(
            hw, chip=H100)))) if measure else {}
    return common.finish(common.interleave(rows, card), out)


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
