"""The l0 sanitizer suite at 4 ranks (port of
``tests/scripts/verify_suite.py``): the acceptance gate of the schedule
verification tier.

* The lint sweep (``repro_torch.tools.schedule_lint`` as a library): every
  (workload, expert-system) point passes l0, at least 10 of them on a
  schedule, and every class of the seeded-mutation corpus is rejected with
  its own first diagnostic.
* Each l0 rejection of ``core/verify.py::mutation_corpus`` timed (5
  runs after a warm one; 1 with ``small``), each with its expected code.
* The l2 cost those rejections avoid: the reference's ``POINTS`` through
  the port's cascade on ``device``, each to level 3 with ``l0`` and ``l2``
  in its record's ``levels_s``. The port's l2 is the kernels' plain
  versions on the CPU and a launch of the Hopper kernel on the card; the
  reference's was an interpret-mode Pallas run (a mean of 551.6 ms in its
  ``BENCH_verify.json``).
* The economics gate the reference set against that l2: the mean l0
  rejection under 10% of the mean l2. The structural checks above are
  hard failures. The ratio is a reading: where it is under 0.1 the
  payload's ``summary.gate`` says "met"; where the port's l2 is too cheap
  for it, "missed", with both means beside it, and the run goes on.

The ``verify-bench/v1`` payload (the reference's keys; ``l2_interpret``
holds the port's l2 rows, ``summary.l2_device`` names where they ran)
goes to ``out``. Wall times differ by machine, so no checked-in copy
stands to equal it.

    PYTHONPATH=src python -m repro_torch.suites.verify --device cuda \
        [--out build/suites/BENCH_verify.json]
"""
from __future__ import annotations

import statistics
import time

from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.design_space import EXPERT_SYSTEMS
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.core.verify import mutation_corpus
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.suites import common
from repro_torch.tools.schedule_lint import lint_mutations, lint_points
from repro_torch.workloads import get_workload

ARTIFACT = "BENCH_verify.json"
GATE = 0.1
REPS = 5                        # timed runs of each corpus entry
POINTS = [
    ("moe_dispatch", dict(n_dev=4, tokens_per_rank=32, d=32, f=64),
     ("FLUX", "DeepEP (NVL)")),
    ("gemm_allgather", dict(n_dev=4, M=256, K=128, N=128), ("FLUX",)),
    ("ring_attention", dict(n_dev=4, BH=2, seq=256, hd=32),
     ("FLUX", "DeepEP (NVL)")),
]


def lint():
    """The lint sweep; ``(point rows, mutation rows)``."""
    prows, pfail = lint_points(quiet=True)
    common.require(not pfail, lambda: f"lint points failed: {pfail}")
    n_ok = sum(r["status"] == "ok" for r in prows)
    common.require(n_ok >= 10, f"only {n_ok} points verified on a schedule")
    mrows, mfail = lint_mutations(quiet=True)
    common.require(not mfail, lambda: f"mutations missed: {mfail}")
    return prows, mrows


def l0_rejections(reps):
    """Each corpus entry's mean rejection ms over ``reps`` timed runs."""
    rows = []
    for entry in mutation_corpus():
        entry["run"]()                            # warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rep = entry["run"]()
            times.append((time.perf_counter() - t0) * 1e3)
        common.require(not rep.ok and rep.errors[0].code == entry["expect"],
                       f"{entry['cls']}: not rejected with "
                       f"{entry['expect']}")
        rows.append({"class": entry["cls"], "code": entry["expect"],
                     "l0_ms": statistics.mean(times)})
    return rows


def l2_costs(mesh, hw):
    """Each point of :data:`POINTS` through the cascade: its level and the
    l0 and l2 ms of its record."""
    rows = []
    for wname, kw, pnames in POINTS:
        w = get_workload(wname, **kw)
        ev = CascadeEvaluator(w, mesh, hw)
        for pname in pnames:
            d = EXPERT_SYSTEMS[pname]
            if w.check(d, hw):
                continue
            res = ev.evaluate(Candidate(directive=d))
            common.require(res.ok, f"{wname} {pname}: {res.diagnostic}")
            rec = res.record
            common.require("l0" in rec.levels_s and "l2" in rec.levels_s,
                           f"{wname} {pname}: levels {rec.levels_s}")
            rows.append({"workload": wname, "point": pname,
                         "level": res.level,
                         "l0_ms": rec.levels_s["l0"] * 1e3,
                         "l2_ms": rec.levels_s["l2"] * 1e3})
    common.require(rows and all(r["level"] == 3 for r in rows),
                   f"l2 points {rows}")
    return rows, ev.device


def run(device="cuda", *, small=False, chip=H100, out=None):
    """The suite on ``device`` (``small``: one timed run a corpus entry);
    the payload goes to ``out`` (default ``build/suites/BENCH_verify.json``).
    Returns a summary: the payload, the lint rows, wall seconds."""
    dev = common.resolve_device(device)
    mesh = VirtualMesh(4, device=dev)
    hw = extract_hardware_context(mesh, chip)
    path = common.artifact_path(out, ARTIFACT)
    t0 = time.perf_counter()
    prows, mrows = lint()
    l0_rows = l0_rejections(1 if small else REPS)
    l2_rows, l2_device = l2_costs(mesh, hw)
    l0_mean = statistics.mean(r["l0_ms"] for r in l0_rows)
    l2_mean = statistics.mean(r["l2_ms"] for r in l2_rows)
    ratio = l0_mean / l2_mean
    payload = common.write_json(path, {
        "schema": "verify-bench/v1",
        "l0_rejections": l0_rows,
        "l2_interpret": l2_rows,
        "summary": {"l0_mean_ms": l0_mean, "l2_mean_ms": l2_mean,
                    "ratio": ratio, "gate_ratio": GATE,
                    "gate": "met" if ratio < GATE else "missed",
                    "l2_device": l2_device},
    })
    return {"artifact": payload, "out": str(path), "device": str(dev),
            "points": prows, "mutations": mrows,
            "n_points_ok": sum(r["status"] == "ok" for r in prows),
            "wall_s": time.perf_counter() - t0}


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
