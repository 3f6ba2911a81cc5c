"""Run the CUCo co-design pipeline on a workload: static analysis ->
fast-path verified seed -> slow-path evolutionary search; prints the
communication graph, the discovered directive and the modeled speedup
(port of ``examples/codesign_search.py``).

    PYTHONPATH=src python -m repro_torch.examples.codesign_search --workload moe_dispatch [--device cuda]

The mesh is the reference's: a ``VirtualMesh`` of 4 ranks (2 for
kv_transfer) on the device, whose cascade runs the Hopper kernels on the
card (their plain versions under ``--device cpu``).
"""
import argparse

from repro_torch.core import SlowPathConfig, slow_path
from repro_torch.core.fast_path import fast_path
from repro_torch.core.hardware import extract_hardware_context
from repro_torch.launch.mesh import make_mesh
from repro_torch.workloads import get_workload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="moe_dispatch",
                    choices=["ring_attention", "moe_dispatch", "kv_transfer",
                             "gemm_allgather"])
    ap.add_argument("--generations", type=int, default=10)
    ap.add_argument("--islands", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = 2 if args.workload == "kv_transfer" else 4
    mesh = make_mesh((n,), ("x",), device=args.device)
    hw = extract_hardware_context(mesh)
    print(hw.topology_summary)

    kw = {}
    if args.workload in ("ring_attention", "moe_dispatch", "gemm_allgather"):
        kw["n_dev"] = mesh.shape["x"]
    w = get_workload(args.workload, **kw)

    print("\n=== fast path (correctness-first) ===")
    seed = fast_path(w, mesh, hw, verbose=True)
    for line in seed.log:
        print(" ", line)
    print("seed directive:\n" + seed.directive.render())

    print("\n=== slow path (evolutionary search) ===")
    res = slow_path(seed, mesh, hw,
                    SlowPathConfig(islands=args.islands,
                                   generations=args.generations),
                    verbose=True)
    print("\ndiscovered:\n" + res.best.directive.render())
    t_seed = 10000.0 / res.seed_score - 1.0
    t_best = 10000.0 / res.best.score - 1.0
    print(f"\nmodeled step: {t_seed:.3f} ms (seed) -> {t_best:.3f} ms "
          f"({t_seed / t_best:.2f}x); behaviors explored: "
          f"{res.archive.coverage()}")
    print("meta-summarizer digests:", res.meta.digests[-1]
          if res.meta.digests else "(none)")
    return res


if __name__ == "__main__":
    main()
