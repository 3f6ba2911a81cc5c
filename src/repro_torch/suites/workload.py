"""Every workload x a spread of valid directives verifies against its oracle
(port of ``tests/scripts/workload_suite.py``: semantics-preserving builders,
the cascade's l2 invariant).

Each workload, at the reference suite's shapes, goes through
``host_baseline`` and ``build`` for each of its directives, and every
output is held elementwise against ``reference()`` within 2e-3 (0.1 on the
int8 wire). On the card the device-initiated points launch
``moe_dispatch.cu`` (DeepEP NVL, pipelined, int8), ``kv_shuttle.cu``
(n = 2, with the FLUX shuttle at ``kv_chunk`` 32), ``gemm_allgather.cu``
(``tile_m`` 32 and 64, DEFERRED) and ``ring_attention.cu`` (four points);
on the CPU their plain versions run. The suite writes no artifact.

    PYTHONPATH=src python -m repro_torch.suites.workload --device cuda
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.cascade import _full_f32
from repro_torch.core.design_space import Directive as D
from repro_torch.core.hardware import H100
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.suites import common
from repro_torch.workloads import get_workload

SEED = 5        # the reference suite's PRNGKey(5)


def cases():
    """``(workload, n ranks, directives, workload kwargs)`` in the
    reference suite's order."""
    return [
        ("ring_attention", 4, [
            D("XLA_COLLECTIVE", placement="STREAM_SPLIT"),
            D("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", contexts=2),
            D("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", ordering="ACQREL",
              contexts=2),
            D("PALLAS_RDMA", "BARRIER", "DEFERRED"),
            D("PALLAS_RDMA", "COUNTER", "TILE_FUSED", granularity="PER_TILE",
              contexts=2),
        ], dict(n_dev=4, BH=4, seq=512, hd=64)),
        ("moe_dispatch", 4, [
            D("XLA_COLLECTIVE", placement="STREAM_SPLIT"),
            D("XLA_COLLECTIVE", placement="DEFERRED"),
            D("XLA_COLLECTIVE", placement="STREAM_SPLIT").with_tunable(
                "wire_i8", 1),
            # the device-initiated kernel (DeepEP analogue): Table 3's NVL
            # point, the pipelined tight dispatch, and its int8 wire
            D("PALLAS_RDMA", "BARRIER", "DEFERRED", "LOCAL", "KERNEL",
              "PER_PEER", "RELEASE", 1),
            D("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", "LOCAL",
              "GRID_STEP", "PER_PEER", "ACQUIRE", 2),
            D("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", "LOCAL",
              "GRID_STEP", "PER_PEER", "ACQUIRE", 2).with_tunable(
                  "wire_i8", 1),
        ], dict(n_dev=4, tokens_per_rank=256, d=128, f=256, skew=3.0)),
        *[("moe_dispatch", 4,
           [D("XLA_COLLECTIVE", placement="STREAM_SPLIT")],
           dict(n_dev=4, tokens_per_rank=128, d=64, f=128, skew=skew))
          for skew in (2.0, 5.0)],
        ("kv_transfer", 2, [
            D("XLA_COLLECTIVE", placement="STREAM_SPLIT"),
            D("PALLAS_RDMA", "SIGNAL", "STREAM_SPLIT"),
            D("PALLAS_RDMA", "SIGNAL", "DEFERRED"),
            D("PALLAS_RDMA", "SIGNAL", "STREAM_SPLIT", ordering="ACQREL"),
            # the per-tile fused K/V GEMM + send chain (the FLUX shuttle)
            D("PALLAS_RDMA", "COUNTER", "TILE_FUSED", granularity="PER_TILE",
              contexts=2).with_tunable("kv_chunk", 32),
        ], {}),
        ("gemm_allgather", 4, [
            D("XLA_COLLECTIVE", placement="STREAM_SPLIT",
              tunables=(("chunks", 4),)),
            D("XLA_COLLECTIVE", placement="STREAM_SPLIT",
              tunables=(("chunks", 2),)),
            D("PALLAS_RDMA", "SIGNAL", "TILE_FUSED", tunables=(("tile_m", 32),)),
            D("PALLAS_RDMA", "SIGNAL", "TILE_FUSED", tunables=(("tile_m", 64),)),
            D("PALLAS_RDMA", "BARRIER", "DEFERRED"),
        ], dict(n_dev=4)),
    ]


def inputs(wname, n, kw, device):
    """The workload, its mesh and the inputs it is checked on."""
    w = get_workload(wname, **kw)
    mesh = VirtualMesh(n, device=device)
    return w, mesh, w.example_inputs(SEED, mesh)


def check(wname, n, directives, kw, device, tol=2e-3):
    """One workload: the host baseline and every directive's build against
    ``reference()``. Returns ``{label: max abs err}``."""
    w, mesh, ins = inputs(wname, n, kw, device)
    errs = {}
    with torch.no_grad(), _full_f32(mesh.device):
        ref = w.reference(*ins)
        errs["host"] = common.allclose(f"{wname} host baseline",
                                       w.host_baseline(mesh)(*ins), ref, tol)
        for d in directives:
            t = 0.1 if d.tunable("wire_i8", 0) else tol
            label = (f"{d.backend} {d.completion} {d.placement} "
                     f"{d.ordering} contexts={d.contexts}") + (
                f" {dict(d.tunables)}" if d.tunables else "")
            errs[label] = common.allclose(f"{wname} {label}",
                                          w.build(d, mesh)(*ins), ref, t)
    return errs


def run(device="cuda", *, small=False, chip=H100, out=None):
    """Every case of :func:`cases` on ``device``. ``small``, ``chip`` and
    ``out`` are taken for the suites' common signature: the shapes are the
    reference suite's at any size, nothing is priced and nothing is
    written. Returns ``{"workloads": [(name, {label: max abs err})],
    "seconds": s}``."""
    del small, chip, out
    dev = common.resolve_device(device)
    t0 = time.perf_counter()
    rows = []
    for wname, n, directives, kw in cases():
        rows.append((wname, check(wname, n, directives, kw, dev)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"workloads": rows, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
