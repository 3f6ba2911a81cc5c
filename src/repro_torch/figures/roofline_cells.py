"""Roofline summary per (arch x shape) from the dry-run artifacts — the
benchmark view of EXPERIMENTS.md §Roofline (port of
``benchmarks/roofline_cells.py``). It reads the port's dry-run artifacts
(``launch/dryrun.py``'s ``artifacts/dryrun_torch/``, the counted torch step
priced on the ``ChipSpec`` the dry run was given), or the directory it is
given; nothing is measured here.

    PYTHONPATH=src python -m repro_torch.figures.roofline_cells [--out PATH]
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.core.hardware import H100
from repro_torch.figures import common
from repro_torch.launch.dryrun import ARTIFACTS


def run(device="cuda", *, chip=H100, mesh=None, measure=True, small=False,
        iters=5, out=None, artifacts=None):
    """One row per artifact of ``artifacts`` (default :data:`ARTIFACTS`)
    with a roofline; ``device``, ``chip``, ``mesh``, ``measure``,
    ``small`` and ``iters`` are taken for the figures' common signature."""
    del device, chip, mesh, measure, small, iters
    rows = []
    for f in sorted(Path(artifacts or ARTIFACTS).glob("*.json")):
        d = json.loads(f.read_text())
        if "skipped" in d or "roofline" not in d:
            continue
        r = d["roofline"]
        name = f"roofline/{d['arch']}__{d['shape']}__{d['mesh']}"
        rows.append((name, r["step_time_s"] * 1e6,
                     f"dom={r['dominant']} comp={r['compute_s'] * 1e3:.1f}ms "
                     f"mem={r['memory_s'] * 1e3:.1f}ms "
                     f"coll={r['collective_s'] * 1e3:.1f}ms "
                     f"useful={d['useful_flops_ratio']:.2f}"))
    return common.finish(rows, out)


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
