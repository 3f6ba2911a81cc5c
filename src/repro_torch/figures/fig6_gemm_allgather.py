"""Paper Figure 6: GEMM + AllGather across square matrix sizes, intra-node
(ici) and inter-node (dcn-rate) links — host all-gather and chunked
STREAM_SPLIT overlap vs the kernelized points: DEFERRED per-peer slab
broadcast and the FLUX-grade TILE_FUSED + COUNTER per-tile broadcast (port
of ``benchmarks/fig6_gemm_allgather.py``).

The inter-node context is the chip given with its peer link at its
``dcn_bw`` (the reference builds it from ``V5E`` whatever the chip; on
``V5E`` the two agree). With ``measure`` the ``ici`` points run at the
paper's shape (4 ranks, f32): host and STREAM_SPLIT as plain torch over a
``VirtualMesh``, deferred and flux through ``gemm_allgather.cu``, each
held to ``reference()``. The one card has no link between its ranks (they
are partitions of it), so the ``dcn`` rows stay modeled, and a measured
speedup is one card holding every rank.

    PYTHONPATH=src python -m repro_torch.figures.fig6_gemm_allgather \
        --device cuda [--chip h100|v5e] [--out PATH]
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import common
from repro_torch.workloads import get_workload

POINTS = (
    ("host", Directive("XLA_COLLECTIVE", placement="DEFERRED")),
    ("stream_split", Directive("XLA_COLLECTIVE", placement="STREAM_SPLIT",
                               contexts=2, tunables=(("chunks", 4),))),
    ("deferred", Directive("PALLAS_RDMA", "SIGNAL", "DEFERRED", "LOCAL",
                           "KERNEL", "PER_PEER", "RELEASE", 2)),
    ("flux", EXPERT_SYSTEMS["FLUX"].with_tunable("tile_m", 128)),
)
POINT_NAMES = tuple(name for name, _ in POINTS)


def run(device="cuda", *, chip=H100, mesh=None, measure=True, small=False,
        iters=5, out=None):
    device = common.resolve_device(device)
    hw = extract_hardware_context(mesh or VirtualMesh(1, device=device),
                                  chip)
    hw_inter = dataclasses.replace(
        hw, chip=dataclasses.replace(chip, ici_link_bw=chip.dcn_bw))
    rows = []
    for size in (2048, 4096, 8192):
        for link, h in (("ici", hw), ("dcn", hw_inter)):
            kw = dict(n_dev=4, M=size, K=size, N=size)
            w = get_workload("gemm_allgather", **kw)
            costs = {name: w.analytic_cost(d, h) * 1e3 for name, d in POINTS}
            p = f"fig6/gemm_ag_{size}_{link}_"
            group = []
            for name, t in costs.items():
                note = "" if name == "host" \
                    else f"speedup={costs['host'] / t:.3f}x"
                group.append((p + name, t * 1e3, note))
            card = common.measured_rows(
                "gemm_allgather", kw, [(p + name, d) for name, d in POINTS],
                h, device=device, small=small,
                iters=iters) if measure and link == "ici" else {}
            rows += common.interleave(group, card)
    return common.finish(rows, out)


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
