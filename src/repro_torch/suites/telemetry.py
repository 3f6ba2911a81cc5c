"""The observability suite at 4 ranks (port of
``tests/scripts/telemetry_suite.py``): the acceptance gate of the tracing
and telemetry layer (``core/trace.py``, ``core/telemetry.py``).

* A 1-island, 6-generation ``slow_path`` on ``gemm_allgather`` (n = 4,
  M = K = N = 4096) with full cascade telemetry: one ``EvalRecord`` per
  candidate, each JSON round-trippable; the generation, island and
  mutation series aggregate consistently; ``SearchTelemetry.write`` gives
  the ``bench-search/v2`` artifact (scores are modeled l3 costs, wall
  times stay out, so it is deterministic: on the reference's ``V5E`` it is
  the reference's checked-in ``BENCH_search.json``).
* The quarantine path: ``kv_transfer`` at n = 2 with its build wedged and
  ``timeout_s=1.5`` carries a quarantined ``EvalRecord``; the wedge is
  released when the suite ends.
* Every workload's FLUX point renders a Perfetto-valid
  ``schedule_timeline`` whose critical path equals ``analytic_cost``
  within 1e-6 s, and a degraded one-rank-down render.
* The observed-vs-modeled ``ScheduleProbe`` check on ``gemm_allgather``
  at (fused, counter, contexts) = (T, T, 2), (T, F, 1), (F, F, 2), n = 4,
  M_l = K = N = 64. On the CPU the probe records the plain version's
  round program, which must pass ``probe.check``. On the card the probe
  build logs the kernel at one CTA a rank: every CTA's log is held to the
  window contract (``check_log``, a hard check), and ``probe.check``
  passes where a card tile is the schedule's round (DEFERRED); where a
  128 x 128 card tile holds several of the schedule's 32-row rounds the
  divergence is returned as the known gap it is (ROADMAP queue 3).

    PYTHONPATH=src python -m repro_torch.suites.telemetry --device cuda \
        [--chip v5e] [--out build/suites/BENCH_search.json]
"""
from __future__ import annotations

import json
import threading
import time

import torch

from repro_torch.core import (ScheduleProbe, SlowPathConfig,
                              schedule_timeline, slow_path, validate_trace)
from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.design_space import EXPERT_SYSTEMS
from repro_torch.core.fast_path import fast_path
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.core.schedule import make_broadcast_schedule
from repro_torch.core.telemetry import EvalRecord
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.suites import common
from repro_torch.workloads import get_workload

ARTIFACT = "BENCH_search.json"
FLUX = EXPERT_SYSTEMS["FLUX"]
CONFIG = SlowPathConfig(islands=1, generations=6, migration_every=7, seed=1)
SHAPE = dict(n_dev=4, M=4096, K=4096, N=4096)
PROBE_POINTS = ((True, True, 2), (True, False, 1), (False, False, 2))


def search(mesh, hw):
    """The telemetry search; ``(result, wall s)``."""
    w = get_workload("gemm_allgather", **SHAPE)
    t0 = time.perf_counter()
    seed = fast_path(w, mesh, hw)
    res = slow_path(seed, mesh, hw, CONFIG)
    return res, time.perf_counter() - t0


def check_search(res, cfg=CONFIG):
    """The reference suite's checks of the search's telemetry."""
    tel = res.telemetry
    require = common.require
    require(tel is not None and tel.workload == "gemm_allgather",
            "the search carries no telemetry of its workload")
    require(len(tel.records) == len(res.db.records),
            f"{len(tel.records)} records for {len(res.db.records)} "
            "candidates")
    for rec in tel.records:
        require(EvalRecord.from_json(rec.to_json()) == rec,
                f"record {rec.cid} does not round-trip through JSON")
    gens = tel.generation_series()
    require([g["gen"] for g in gens] == list(range(cfg.generations + 1)),
            f"generations {[g['gen'] for g in gens]}")
    require(all(g["archive_coverage"] is not None for g in gens),
            "a generation without archive coverage")
    require(sum(g["evals"] for g in gens) == len(tel.records),
            "the generation series does not add up to the records")
    ok = [r for r in tel.records if r.level >= 3]
    require(ok, "the search landed no level-3 candidate")
    require(all(r.t_model_ms is not None and "l3" in r.levels_s for r in ok),
            "a level-3 record without its model time or l3 level")
    require([i["island"] for i in tel.island_series()] == [0],
            "the island series is not island 0 alone")
    muts = {m["mutation"]: m for m in tel.mutation_stats()}
    require("island-seed" in muts and muts["island-seed"]["wins"] >= 1,
            "the island seed never won")
    require(sum(m["wins"] for m in muts.values()) >= 1, "no mutation won")


def write_artifact(tel, path, cfg=CONFIG):
    """``SearchTelemetry.write`` with the reference suite's ``meta``;
    returns the payload as read back."""
    meta = {"islands": cfg.islands, "generations": cfg.generations,
            "seed": cfg.seed, "shape": " ".join(f"{k}={v}"
                                                for k, v in SHAPE.items())}
    tel.write(path, meta=meta)
    text = open(path).read()
    payload = json.loads(text)
    common.require(payload["schema"] == "bench-search/v2",
                   f"schema {payload['schema']}")
    common.require(payload["best"]["score"] == payload["totals"]["best_score"],
                   "the best record's score is not the best score")
    common.require("Infinity" not in text, "a non-finite number was written")
    return payload


def quarantine(device, chip, release):
    """``kv_transfer`` at n = 2 with its build wedged until ``release`` is
    set: the evaluation is abandoned at ``timeout_s`` and carries a
    quarantined record. Returns the record's dict."""
    wedge = get_workload("kv_transfer")
    wedge.build = lambda d, m: (lambda *xs: release.wait(60.0))
    mesh2 = VirtualMesh(2, device=device)
    ev = CascadeEvaluator(wedge, mesh2, extract_hardware_context(mesh2, chip),
                          timeout_s=1.5)
    res = ev.evaluate(Candidate(directive=FLUX))
    common.require(res.quarantined and res.record is not None,
                   "the wedged candidate was not quarantined")
    common.require(res.record.quarantined
                   and "quarantine" in res.record.levels_s,
                   "the quarantine record is not marked")
    common.require(ev.quarantine_report()[0]["record"]["quarantined"] is True,
                   "the quarantine report lacks the record")
    return res.record.to_dict()


def timelines(hw):
    """Every workload's FLUX timeline (critical path == ``analytic_cost``
    within 1e-6 s) and its one-rank-down render. Returns ``{name: (events,
    critical path ms)}``."""
    out = {}
    for name in ("gemm_allgather", "moe_dispatch", "ring_attention",
                 "kv_transfer"):
        wl = get_workload(name)
        tl = schedule_timeline(wl, FLUX, hw)
        n_ev = validate_trace(tl.to_dict())
        expect = wl.analytic_cost(FLUX, hw)
        common.require(abs(tl.critical_path_s - expect) < 1e-6,
                       f"timeline {name}: critical path "
                       f"{tl.critical_path_s!r} s, analytic_cost {expect!r}")
        dtl = schedule_timeline(wl, FLUX, hw,
                                live_ranks=tuple(range(wl.n_dev - 1)))
        common.require(dtl.degraded, f"timeline {name}: not degraded")
        validate_trace(dtl.to_dict())
        out[name] = (n_ev, tl.critical_path_s * 1e3)
    return out


def probes(device):
    """The observed-vs-modeled check of each of :data:`PROBE_POINTS`.
    Returns one dict a point: the probe's summary, or on the card the
    log's summary and, where the card's round is not the schedule's, the
    divergence."""
    from repro_torch.kernels import gemm_allgather as ga
    g = torch.Generator(device=device).manual_seed(5)
    n, M_l, K, N = 4, 64, 64, 64
    a = torch.randn((n, M_l, K), generator=g, device=device)
    b = torch.randn((K, N), generator=g, device=device)
    ref = ga.gemm_allgather_plain(a, b)
    out = []
    for fused, counter, contexts in PROBE_POINTS:
        knobs = dict(tile_m=32, fused=fused, counter=counter,
                     contexts=contexts)
        probe = ScheduleProbe()
        got = ga.gemm_allgather(a, b, VirtualMesh(n, device=device), probe=probe,
                                **knobs)
        common.allclose(f"probe gemm_allgather {knobs}", got, ref, 2e-3)
        sched = make_broadcast_schedule(n, M_l, 32, fused)
        row = dict(knobs)
        if a.device.type == "cuda":
            _, events = ga.gemm_allgather_logged(a, b, **knobs)
            row["log"] = ga.check_log(events, n=n, M_l=M_l, N=N, **knobs)
        try:
            row["probe"] = probe.check(sched, contexts, counter=counter)
        except AssertionError as err:
            common.require(a.device.type == "cuda" and fused,
                           f"probe {knobs}: observed != modeled: {err}")
            row["divergence"] = str(err).splitlines()[0]
        out.append(row)
    return out


def run(device="cuda", *, small=False, chip=H100, out=None):
    """The suite on ``device`` with the search priced on ``chip``; writes
    the artifact to ``out`` (default ``build/suites/BENCH_search.json``).
    Returns a summary: the payload, wall s per candidate, the quarantine
    record, the timelines and the probe rows."""
    del small                     # one size: the reference suite's
    dev = common.resolve_device(device)
    mesh = VirtualMesh(4, device=dev)
    hw = extract_hardware_context(mesh, chip)
    path = common.artifact_path(out, ARTIFACT)
    release = threading.Event()
    try:
        res, wall = search(mesh, hw)
        check_search(res)
        payload = write_artifact(res.telemetry, path)
        qrec = quarantine(dev, chip, release)
    finally:
        release.set()             # the wedged build returns now
    evals = len(res.telemetry.records)
    level_s = {}
    for rec in res.telemetry.records:
        for k, v in rec.levels_s.items():
            level_s[k] = level_s.get(k, 0.0) + v
    return {
        "artifact": payload, "out": str(path), "chip": chip.name,
        "device": str(dev), "evals": evals, "wall_s": wall,
        "wall_s_per_candidate": wall / evals,
        "levels_s_per_candidate": {k: v / evals for k, v in level_s.items()},
        "best_score": payload["totals"]["best_score"],
        "best_t_model_ms": payload["best"]["t_model_ms"],
        "quarantine": {k: qrec[k] for k in ("rejection", "stage",
                                            "elapsed_s", "quarantined")},
        "timelines": timelines(hw),
        "probes": probes(dev),
    }


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
