"""Paper Figure 3: Flash Attention with Context Parallelism — host-driven
NCCL-analogue vs CUCo device-initiated ring kernels, over SEQ x HD (port of
``benchmarks/fig3_flash_attention.py``).

Four points per shape: the host baseline, the lazy-fence TILE_PIPELINED
overlap point (cuco), and the two kernelized ``RingSchedule``
realizations — the DEFERRED in-kernel rotation and the FLUX ring
(TILE_FUSED + COUNTER per-chunk rotation). Modeled latency at the paper's
deployment (4 ranks, ring) on the ``ChipSpec`` given. With ``measure`` each
point ``check`` accepts runs at that shape (BH 96, f32) through
``ring_attention.cu`` (host: plain torch), held to the oracle in slices of
heads; ``cuco`` is PER_PEER, which the ring's check rejects, so it has no
measured row. The 4 ranks are partitions of one card: a measured speedup
is one card holding every rank.

    PYTHONPATH=src python -m repro_torch.figures.fig3_flash_attention \
        --device cuda [--chip h100|v5e] [--out PATH]
"""
from __future__ import annotations

from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import common
from repro_torch.workloads import get_workload

POINTS = (
    ("host", Directive("XLA_COLLECTIVE", placement="DEFERRED")),
    ("cuco", Directive("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED",
                       contexts=2)),
    ("deferred", Directive("PALLAS_RDMA", "SIGNAL", "DEFERRED", "LOCAL",
                           "KERNEL", "PER_PEER", "RELEASE", 2)),
    ("flux", EXPERT_SYSTEMS["FLUX"].with_tunable("kv_chunk", 64)),
)
POINT_NAMES = tuple(name for name, _ in POINTS)


def run(device="cuda", *, chip=H100, mesh=None, measure=True, small=False,
        iters=5, out=None):
    device = common.resolve_device(device)
    hw = extract_hardware_context(mesh or VirtualMesh(1, device=device),
                                  chip)
    rows = []
    for seq in (4096, 8192):
        for hd in (32, 64):
            kw = dict(n_dev=4, BH=12 * 8, seq=seq, hd=hd)
            w = get_workload("ring_attention", **kw)
            costs = {name: w.analytic_cost(d, hw) * 1e3
                     for name, d in POINTS}
            shape = []
            for name, t in costs.items():
                note = "" if name == "host" \
                    else f"speedup={costs['host'] / t:.3f}x"
                shape.append((f"fig3/ring_attn_seq{seq}_hd{hd}_{name}",
                              t * 1e3, note))
            card = common.measured_rows(
                "ring_attention", kw,
                [(f"fig3/ring_attn_seq{seq}_hd{hd}_{name}", d)
                 for name, d in POINTS], hw, device=device, small=small,
                iters=iters) if measure else {}
            rows += common.interleave(shape, card)
    return common.finish(rows, out)


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
