"""The scaled-search suite at 4 ranks (port of
``tests/scripts/search_scale_suite.py``): the acceptance gate of the batched
cascade and the warm-start store.

* Batched against sequential ring search: ``ring_attention`` (BH 4, seq
  512, hd 64) through ``slow_path(batched=True)`` gives the same
  ``db.history()`` and telemetry payload as the sequential run. On a CUDA
  device ``CascadeEvaluator.evaluate_batch`` runs one worker (the kernels
  share one stream), so there "batched" is the sequential order and the
  parity holds by construction; on the CPU the batch runs on 3 threads.
* Warm-start economics on ``gemm_allgather`` 2048^3: a cold search saves
  its store (next to the artifact, under ``build/``); the warm resume
  re-evaluates no cached directive, reaches the cold best in at most half
  the fresh evaluations the cold run needed, and resumes coverage at
  least where it left off. The store round-trips exactly.
* Cross-workload transfer: the ``gemm_allgather`` store seeds a
  ``moe_dispatch`` search (1024 tokens a rank, d 256, f 512) through
  ``transfer_seeds``, with no cache hit across the fingerprints, and the
  same 2x payoff against the cold ``moe_dispatch`` search wherever the
  cold search leaves it room (4 evaluations or more to its best; the
  summary's ``transfer_gate`` says "met" or "no room").
* The checked-in ``BENCH_search.json`` has schema ``bench-search/v2`` and
  the scale section's three keys.

The ``bench-search-scale/v1`` artifact (wall times excluded; on the
reference's ``V5E`` it is the reference's checked-in
``BENCH_search_scale.json``) goes to ``out``.

    PYTHONPATH=src python -m repro_torch.suites.search_scale --device cuda \
        [--chip v5e] [--out build/suites/BENCH_search_scale.json]
"""
from __future__ import annotations

import json
import time

from repro_torch.compat import REPO_ROOT
from repro_torch.core import SlowPathConfig, slow_path
from repro_torch.core.cascade import CascadeEvaluator
from repro_torch.core.database import CandidateDB
from repro_torch.core.design_space import directive_key
from repro_torch.core.fast_path import fast_path
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.suites import common
from repro_torch.workloads import get_workload

ARTIFACT = "BENCH_search_scale.json"
# the fewest evaluations a cold search may need to leave a transferred one
# room for the 2x payoff (see ``transfer``)
MIN_COLD_FOR_PAYOFF = 4


class CountingEvaluator(CascadeEvaluator):
    """The cascade, remembering the key of every directive it evaluated."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.evaluated = []

    def _evaluate(self, cand, publish=True):
        self.evaluated.append(directive_key(cand.directive))
        return super()._evaluate(cand, publish=publish)


def evals_to(records, best):
    """Fresh (not cached) evaluations up to the first record at ``best``;
    ``None`` when no record reaches it."""
    fresh = 0
    for r in records:
        if not r.cached:
            fresh += 1
        if r.score >= best:
            return fresh
    return None


def ring_parity(mesh, hw):
    ring = get_workload("ring_attention", n_dev=4, BH=4, seq=512, hd=64)
    seed = fast_path(ring, mesh, hw)
    cfg = SlowPathConfig(islands=2, generations=3, seed=2)
    seq = slow_path(seed, mesh, hw, cfg)
    bat = slow_path(seed, mesh, hw, cfg, batched=True, eval_workers=3)
    common.require(seq.history == bat.history,
                   "batched ring search diverged from sequential")
    common.require(json.dumps(seq.telemetry.payload(), sort_keys=True)
                   == json.dumps(bat.telemetry.payload(), sort_keys=True),
                   "batched telemetry payload diverged")
    common.require(bat.best.score >= bat.seed_score,
                   "the batched search lost its seed's score")
    return {"evals": len(bat.history), "best_score": bat.best.score,
            "seed_score": bat.seed_score, "history_equal": True,
            "payload_equal": True}


def warm_start(mesh, hw, store):
    gemm = get_workload("gemm_allgather", n_dev=4, M=2048, K=2048, N=2048)
    seed = fast_path(gemm, mesh, hw)
    cfg = SlowPathConfig(islands=2, generations=4, seed=1)
    cold = slow_path(seed, mesh, hw, cfg, batched=True, save_to=str(store))
    cold_best = cold.best.score
    cold_to_best = next(i + 1 for i, r in enumerate(cold.db.records)
                        if r.score >= cold_best)
    ev = CountingEvaluator(gemm, mesh, hw)
    warm = slow_path(seed, mesh, hw, cfg, evaluator=ev,
                     warm_start=str(store))
    saved = {directive_key(r.directive) for r in cold.db.records}
    common.require(not set(ev.evaluated) & saved,
                   "warm start re-evaluated a cached directive")
    warm_to_best = evals_to(warm.db.records, cold_best)
    common.require(warm_to_best is not None,
                   "warm start never reached the cold-start best")
    common.require(warm_to_best <= cold_to_best // 2,
                   f"warm start needed {warm_to_best} fresh evals to reach "
                   f"the cold best; cold needed {cold_to_best} (payoff must "
                   "be >=2x)")
    common.require(warm.archive.coverage() >= cold.archive.coverage(),
                   "the warm start's coverage dropped")
    sc = warm.telemetry.scale
    common.require(sc["warm_start"] and sc["cache_hits"] > 0,
                   f"the warm start served no cache hit: {sc}")
    db2 = CandidateDB.load(str(store))
    common.require(db2.history() == cold.db.history(),
                   "the store does not round-trip")
    return {"cold_evals_to_best": cold_to_best,
            "warm_fresh_evals_to_best": warm_to_best,
            "cache_hits": sc["cache_hits"], "cold_best_score": cold_best,
            "warm_best_score": warm.best.score,
            "coverage_saved": cold.archive.coverage(),
            "coverage_resumed": warm.archive.coverage()}, len(db2.records)


def transfer(mesh, hw, store):
    moe = get_workload("moe_dispatch", n_dev=4, tokens_per_rank=1024, d=256,
                       f=512)
    seed = fast_path(moe, mesh, hw)
    cfg = SlowPathConfig(islands=3, generations=3, seed=2)
    cold = slow_path(seed, mesh, hw, cfg, batched=True)
    cold_best = cold.best.score
    cold_to_best = next(i + 1 for i, r in enumerate(cold.db.records)
                        if r.score >= cold_best)
    xfer = slow_path(seed, mesh, hw, cfg, batched=True, warm_start=str(store))
    xs = xfer.telemetry.scale
    common.require(xs["warm_start"] and xs["transferred_seeds"] > 0,
                   f"no seed was transferred: {xs}")
    common.require(xs["cache_hits"] == 0,
                   "a cached score crossed a fingerprint boundary")
    common.require(xfer.best.score >= xfer.seed_score,
                   "the transferred search lost its seed's score")
    gen0 = [r for r in xfer.db.records
            if r.gen == 0 and r.mutation == "transfer-seed"]
    common.require(gen0, "no transferred elite seeded generation zero")
    xfer_to_best = evals_to(xfer.db.records, cold_best)
    common.require(xfer_to_best is not None,
                   "transferred search never reached the cold best")
    # A transferred search evaluates the fast-path seed first, so it passes
    # the seed's score at its second fresh evaluation at the soonest; a
    # cold search that needed under 4 leaves a 2x payoff no room (with 1
    # the seed is the best and the bar is 0).
    gate = "no room" if cold_to_best < MIN_COLD_FOR_PAYOFF else "met"
    if gate == "met":
        common.require(xfer_to_best <= cold_to_best // 2,
                       f"transferred moe_dispatch search needed "
                       f"{xfer_to_best} fresh evals to reach the cold best; "
                       f"cold needed {cold_to_best} (payoff must be >=2x)")
    return gate, {"transferred_seeds": xs["transferred_seeds"],
            "gen0_transfer_seeds": len(gen0),
            "gen0_transfer_ok": sum(1 for r in gen0
                                    if r.result and r.result.ok),
            "cold_evals_to_best": cold_to_best,
            "transfer_fresh_evals_to_best": xfer_to_best,
            "cold_best_score": cold_best, "best_score": xfer.best.score,
            "seed_score": xfer.seed_score}


def check_search_artifact(path=REPO_ROOT / "BENCH_search.json"):
    """The checked-in search artifact rode the schema bump to v2 and has
    the scale section."""
    payload = common.read_json(path)
    common.require(payload["schema"] == "bench-search/v2",
                   f"{path} is stale: schema {payload['schema']}")
    common.require(set(payload["scale"]) == {"warm_start", "cache_hits",
                                             "transferred_seeds"},
                   f"{path}: scale keys {sorted(payload['scale'])}")


def run(device="cuda", *, small=False, chip=H100, out=None):
    """The suite on ``device`` with every search priced on ``chip``; the
    artifact goes to ``out`` (default
    ``build/suites/BENCH_search_scale.json``), the warm-start store beside
    it. Returns a summary: the artifact, the payoffs, whether the batch
    ran on threads, the transfer gate, and wall seconds. The payoffs are
    the cold run's evaluations to its best over the fresh ones the warm or
    transferred run needed (at least 1)."""
    del small                     # one size: the reference suite's
    dev = common.resolve_device(device)
    mesh = VirtualMesh(4, device=dev)
    hw = extract_hardware_context(mesh, chip)
    path = common.artifact_path(out, ARTIFACT)
    store = path.with_name(path.stem + "_store.json")
    bench = {"schema": "bench-search-scale/v1", "n_dev": 4}
    t0 = time.perf_counter()
    bench["ring_parity"] = ring_parity(mesh, hw)
    bench["warm_start"], stored = warm_start(mesh, hw, store)
    gate, bench["transfer"] = transfer(mesh, hw, store)
    check_search_artifact()
    common.write_json(path, bench)
    ws, tr = bench["warm_start"], bench["transfer"]
    return {
        "artifact": bench, "out": str(path), "chip": chip.name,
        "device": str(dev), "wall_s": time.perf_counter() - t0,
        "batched_on_threads": dev.type != "cuda",
        "store_records": stored,
        "warm_payoff": ws["cold_evals_to_best"]
        / max(1, ws["warm_fresh_evals_to_best"]),
        "transfer_payoff": tr["cold_evals_to_best"]
        / max(1, tr["transfer_fresh_evals_to_best"]),
        "transfer_gate": gate,
    }


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
