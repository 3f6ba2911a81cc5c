"""Standalone schedule sanitizer CLI (port of ``tools/schedule_lint.py``,
the reference's CI ``verify-lint`` job).

Runs the l0 static verifier (``src/repro_torch/core/verify.py``) over every
registered workload x expert-system design point — the exact programs the
cascade's l0 level would check — plus the degraded (dropped-rank)
variants and the full ``TUNABLES['contexts']`` window-depth grid.  With
``--mutations`` it additionally replays the seeded-mutation corpus and
requires every bug class to be flagged with its class-specific
diagnostic. Nothing runs on a device.

Usage:
    PYTHONPATH=src python -m repro_torch.tools.schedule_lint [--mutations]
        [--json F] [--catalog] [--quiet]

Exit code 1 on any clean-point failure or any uncaught mutation.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def lint_points(quiet=False):
    """Lint every (workload, expert-system point) pair: the directive's
    own program at its ``contexts`` plus the schedule swept across the
    ``TUNABLES`` contexts grid and its degraded one-rank-down variant.
    Returns (rows, failures)."""
    from repro_torch.core.design_space import (CONSERVATIVE,
                                               EXPERT_SYSTEMS, TUNABLES)
    from repro_torch.core.verify import verify_directive, verify_schedule
    from repro_torch.workloads import WORKLOADS, get_workload

    points = dict(EXPERT_SYSTEMS)
    points["CONSERVATIVE"] = CONSERVATIVE
    rows, failures = [], []
    for wname in sorted(WORKLOADS):
        wl = get_workload(wname)
        for pname, d in sorted(points.items()):
            t0 = time.perf_counter()
            viol = wl.check(d, None)
            if viol:
                status, detail = "invalid", "; ".join(viol)
            else:
                rep = verify_directive(wl, d)
                if rep is None:
                    status, detail = "vacuous", "no collective schedule"
                else:
                    # sweep the full contexts grid + the degrade splice
                    sched = wl.collective_schedule(d)
                    knobs = wl.kernel_knobs(d)
                    grid = verify_schedule(sched, knobs=knobs)
                    reps = [rep, grid]
                    if sched.n > 2:
                        live = tuple(range(sched.n - 1))
                        reps.append(verify_schedule(
                            sched.degrade(live), knobs=knobs,
                            contexts=tuple(TUNABLES["contexts"]),
                            parent=sched, live=live))
                    bad = [r for r in reps if not r.ok]
                    status = "fail" if bad else "ok"
                    detail = "; ".join(r.summary() for r in bad) if bad \
                        else f"{sum(r.checked.get('ops', 0) for r in reps)} ops"
            row = {"workload": wname, "point": pname, "status": status,
                   "detail": detail,
                   "elapsed_ms": (time.perf_counter() - t0) * 1e3}
            rows.append(row)
            if status == "fail":
                failures.append(row)
            if not quiet:
                print(f"  {wname:<16} {pname:<16} {status:<8} "
                      f"{row['elapsed_ms']:7.1f} ms  {detail[:90]}")
    return rows, failures


def lint_mutations(quiet=False):
    """Replay the seeded-mutation corpus: every class must be rejected
    with its expected checker code as the *first* diagnostic."""
    from repro_torch.core.verify import mutation_corpus

    rows, failures = [], []
    for e in mutation_corpus():
        t0 = time.perf_counter()
        rep = e["run"]()
        first = rep.errors[0].code if rep.errors else None
        caught = (not rep.ok) and first == e["expect"]
        row = {"class": e["cls"], "expect": e["expect"], "first": first,
               "caught": caught, "diagnostic": rep.summary(limit=1),
               "elapsed_ms": (time.perf_counter() - t0) * 1e3}
        rows.append(row)
        if not caught:
            failures.append(row)
        if not quiet:
            mark = "caught" if caught else "MISSED"
            print(f"  {e['cls']:<24} -> {str(first):<20} {mark:<7} "
                  f"{row['elapsed_ms']:6.1f} ms")
    return rows, failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mutations", action="store_true",
                    help="also replay the seeded-mutation corpus")
    ap.add_argument("--json", metavar="FILE",
                    help="write the full report as JSON")
    ap.add_argument("--catalog", action="store_true",
                    help="print the checker catalog and exit")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.catalog:
        from repro_torch.core.verify import CHECKS
        for code, desc in CHECKS.items():
            print(f"{code:<22} {desc}")
        return 0

    if not args.quiet:
        print("schedule_lint: workload x expert-system points")
    rows, failures = lint_points(quiet=args.quiet)
    report = {"schema": "schedule-lint/v1", "points": rows}
    if args.mutations:
        if not args.quiet:
            print("schedule_lint: seeded-mutation corpus")
        mrows, mfail = lint_mutations(quiet=args.quiet)
        report["mutations"] = mrows
        failures += mfail
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_vac = sum(r["status"] in ("vacuous", "invalid") for r in rows)
    print(f"schedule_lint: {n_ok} points verified, {n_vac} vacuous/invalid, "
          f"{len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
