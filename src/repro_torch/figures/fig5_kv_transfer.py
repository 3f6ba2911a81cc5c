"""Paper Figure 5: KV-cache transfer latency across sequence lengths and KV
dims — host bundled transfer vs CUCo chained GPU-triggered sends (port of
``benchmarks/fig5_kv_transfer.py``).

With ``measure`` both points run at the paper's shape (2 ranks, d 4096,
f32): the host row as plain torch over a ``VirtualMesh``, cuco through
``kv_shuttle.cu`` (chained K -> V sends), each held to ``reference()``.
The prefill and decode ranks are partitions of one card: a measured
speedup is one card holding both.

    PYTHONPATH=src python -m repro_torch.figures.fig5_kv_transfer \
        --device cuda [--chip h100|v5e] [--out PATH]
"""
from __future__ import annotations

from repro_torch.core.design_space import Directive
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import common
from repro_torch.workloads import get_workload

POINTS = (("host", Directive("XLA_COLLECTIVE", placement="DEFERRED")),
          ("cuco", Directive("PALLAS_RDMA", "SIGNAL", "STREAM_SPLIT")))
POINT_NAMES = tuple(name for name, _ in POINTS)


def run(device="cuda", *, chip=H100, mesh=None, measure=True, small=False,
        iters=5, out=None):
    device = common.resolve_device(device)
    hw = extract_hardware_context(mesh or VirtualMesh(1, device=device),
                                  chip)
    rows = []
    (_, host), (_, cuco) = POINTS
    for T in (2048, 4096, 8192):
        for dk in (512, 1024):
            kw = dict(T=T, d=4096, dk=dk)
            w = get_workload("kv_transfer", **kw)
            th = w.analytic_cost(host, hw) * 1e3
            tc = w.analytic_cost(cuco, hw) * 1e3
            p = f"fig5/kv_T{T}_dk{dk}_"
            card = common.measured_rows(
                "kv_transfer", kw, [(p + "host", host), (p + "cuco", cuco)],
                hw, device=device, small=small,
                iters=iters) if measure else {}
            rows += common.interleave(
                [(p + "host", th * 1e3, ""),
                 (p + "cuco", tc * 1e3, f"speedup={th / tc:.3f}x")], card)
    return common.finish(rows, out)


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
