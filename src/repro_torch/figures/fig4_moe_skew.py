"""Paper Figure 4: DeepSeek-V3 MoE layer across expert skew (2:1..5:1) —
sequential host flow vs CUCo self/remote split (+ int8 wire) vs the
device-initiated dispatch/combine kernel (port of
``benchmarks/fig4_moe_skew.py``). Kernelized rows cover both realized
expert points: DeepEP (tight per-peer wire, per-edge signal, pipelined peer
compute) and FLUX (tile-fused expert GEMM with per-tile combine writes,
COUNTER completion).

With ``measure`` every point runs at the paper's shape (4096 tokens a
rank, d 7168, f 2048, f32): the host and STREAM_SPLIT rows as plain torch
over a ``VirtualMesh``, the kernelized rows through ``moe_dispatch.cu``,
each held to ``reference()`` (2e-3; 0.1 on the int8 wire). The n ranks are
partitions of one card: a measured speedup is one card holding every rank.

    PYTHONPATH=src python -m repro_torch.figures.fig4_moe_skew --n-dev 8 \
        --device cuda [--chip h100|v5e] [--out PATH]

sweeps the 8-expert shape (default 2, the paper shape)."""
from __future__ import annotations

from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import common
from repro_torch.workloads import get_workload

POINT_NAMES = ("host", "cuco", "cuco_i8", "deepep_nvl", "deepep_tight",
               "deepep_padded", "flux", "flux_tuned")


def points():
    """The figure's directives, in the order of its rows."""
    host = Directive("XLA_COLLECTIVE", placement="DEFERRED",
                     granularity="PER_CHUNK")
    cuco = Directive("XLA_COLLECTIVE", placement="STREAM_SPLIT",
                     granularity="PER_PEER", tunables=(("tight", 1),))
    cuco_q = cuco.with_tunable("wire_i8", 1)
    # Table-3 DeepEP (NVL) coordinates: device-initiated, per-peer, deferred
    deepep_nvl = Directive("PALLAS_RDMA", "BARRIER", "DEFERRED", "LOCAL",
                           "KERNEL", "PER_PEER", "RELEASE", 1,
                           tunables=(("tight", 1),))
    # the slow-path refinement of that point: signal completion + pipelined
    # per-peer expert compute + double-buffered sends (tight dispatch)
    deepep_pipe = Directive("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED",
                            "LOCAL", "GRID_STEP", "PER_PEER", "ACQUIRE", 2,
                            tunables=(("tight", 1),))
    # ablation: same kernel forced onto padded max-capacity blocks
    deepep_padded = Directive("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED",
                              "LOCAL", "GRID_STEP", "PER_CHUNK", "ACQUIRE", 2)
    # Table-3 FLUX coordinates: tile-fused expert GEMM, per-tile combine
    # writes, COUNTER completion — plus a slow-path-refined variant
    flux = EXPERT_SYSTEMS["FLUX"]
    flux_tuned = flux.with_tunable("block_tokens", 128)
    return dict(zip(POINT_NAMES, (host, cuco, cuco_q, deepep_nvl,
                                  deepep_pipe, deepep_padded, flux,
                                  flux_tuned)))


def shape(n_dev, skew):
    return dict(n_dev=n_dev, tokens_per_rank=4096, d=7168, f=2048,
                skew=skew)


def run(device="cuda", *, chip=H100, mesh=None, measure=True, small=False,
        iters=5, out=None, n_dev=2):
    device = common.resolve_device(device)
    hw = extract_hardware_context(mesh or VirtualMesh(1, device=device),
                                  chip)
    pts = points()
    rows = []
    for skew in (2.0, 3.0, 4.0, 5.0):
        w = get_workload("moe_dispatch", **shape(n_dev, skew))
        t = {name: w.analytic_cost(d, hw) * 1e3 for name, d in pts.items()}
        th = t["host"]
        counts = w._counts(w.T)
        tight_tok = int(counts.sum() - counts[0])
        padded_tok = int(counts.max()) * (w.n_dev - 1)
        p = f"fig4/moe_skew{skew:.0f}_"
        group = [
            (p + "host", th * 1e3, ""),
            (p + "cuco", t["cuco"] * 1e3, f"speedup={th / t['cuco']:.3f}x"),
            (p + "cuco_i8", t["cuco_i8"] * 1e3,
             f"speedup={th / t['cuco_i8']:.3f}x"),
            (p + "deepep_nvl", t["deepep_nvl"] * 1e3,
             f"speedup={th / t['deepep_nvl']:.3f}x"),
            (p + "deepep_tight", t["deepep_tight"] * 1e3,
             f"speedup={th / t['deepep_tight']:.3f}x wire={tight_tok}tok "
             f"(padded={padded_tok}tok, "
             f"{padded_tok / max(1, tight_tok):.2f}x)"),
            (p + "deepep_padded", t["deepep_padded"] * 1e3,
             f"speedup={th / t['deepep_padded']:.3f}x"),
            (p + "flux", t["flux"] * 1e3,
             f"speedup={th / t['flux']:.3f}x tile-fused combine"),
            (p + "flux_tuned", t["flux_tuned"] * 1e3,
             f"speedup={th / t['flux_tuned']:.3f}x block_tokens=128"),
        ]
        card = common.measured_rows(
            "moe_dispatch", shape(n_dev, skew),
            [(p + name, d) for name, d in pts.items()], hw, device=device,
            small=small, iters=iters) if measure else {}
        rows += common.interleave(group, card)
    return common.finish(rows, out)


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__, n_dev=2))
