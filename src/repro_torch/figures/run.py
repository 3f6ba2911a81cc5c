"""Every paper table and figure on the port, one module each (port of
``benchmarks/run.py``). Prints ``name,us_per_call,derived`` CSV and writes
one ``bench-rows/v1`` table per module under ``--out`` (default
``build/figures/``); exits 1 if any module failed.

    PYTHONPATH=src python -m repro_torch.figures.run --device cuda \
        [--chip h100|v5e] [--out DIR] [--small] [--iters N]

The modules get a 4-rank ``VirtualMesh`` on the device (the paper's
deployment size, as the reference's 4 host devices): fig9-13's ring runs
its 4 ranks there; the other figures build their own meshes of their
workloads' ranks for the measured points.
"""
from __future__ import annotations

import sys
import traceback
from pathlib import Path

from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import (common, fig3_flash_attention, fig4_moe_skew,
                                 fig5_kv_transfer, fig6_gemm_allgather,
                                 fig9_13_ablations, roofline_cells,
                                 table5_moe_phases)

MODULES = (fig3_flash_attention, fig4_moe_skew, fig5_kv_transfer,
           fig6_gemm_allgather, table5_moe_phases, fig9_13_ablations,
           roofline_cells)


def main(argv=None) -> int:
    ap = common.parser(__doc__, "one bench-rows/v1 table per module in "
                                "this directory (default build/figures/)")
    ap.add_argument("--small", action="store_true",
                    help="measure at the test size (the modeled rows stay)")
    ap.add_argument("--iters", type=int, default=5,
                    help="timed calls per measured point")
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    mesh = VirtualMesh(4, device=device)
    root = Path(args.out or common.FIGURES_DIR)
    print("name,us_per_call,derived")
    failures = 0
    for m in MODULES:
        short = m.__name__.rsplit(".", 1)[1]
        try:
            for name, us, derived in m.run(
                    device, chip=common.CHIPS[args.chip], mesh=mesh,
                    small=args.small, iters=args.iters,
                    out=root / f"{short}.json"):
                print(f"{name},{us:.3f},{derived}", flush=True)
        except Exception:
            failures += 1
            print(f"{m.__name__},ERROR,", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
