"""Paper Figures 9-13 (ablations) on the ring-attention workload (the
richest valid design space: 2 backends x 4 placements x completions x
orderings x buffering); port of ``benchmarks/fig9_13_ablations.py``:

  fig9   — naive iterative prompting (single chain, diff-only, no
           population/archive/meta) vs full CUCo.
  fig10/11 — fast-path + slow-path vs slow-path-only: random unverified
           island seed AND an unbounded mutation operator (the paper's
           "unconstrained generation" regime) — wasted-evaluation fraction.
  fig12/13 — two-phase explore->exploit vs exploit-only schedule (best score
           + MAP-Elites behavior coverage).

Every search runs through the port's cascade on the mesh's device: l0,
l1 (on the card, the kernel build), l2 at the workload's verification size
(on the card through ``ring_attention.cu``, on the CPU its plain version)
and l3 on ``chip``. The ring's ranks are the mesh's (``run.py`` passes 4).
The rows are the reference's; with ``measure`` one more row,
``fig9_13/wall_per_candidate_card``, holds the searches' wall us a
candidate. ``small`` lowers the generations to :data:`SMALL_GENS`.

    PYTHONPATH=src python -m repro_torch.figures.fig9_13_ablations \
        --device cuda [--chip h100|v5e] [--out PATH]
"""
from __future__ import annotations

import dataclasses
import random
import time

import torch

from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.design_space import CONSERVATIVE, random_directive
from repro_torch.core.fast_path import fast_path
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.core.mutation import HeuristicMutator, MutationContext
from repro_torch.core.slow_path import SlowPathConfig, slow_path
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import common
from repro_torch.workloads import get_workload

GENS = 10
SMALL_GENS = 2


def _workload(mesh):
    return get_workload("ring_attention", n_dev=mesh.shape["x"], BH=16,
                        seq=8192, hd=64)


def naive_iterative(w, mesh, hw, gens, seed=0):
    """Single-program refinement: diff patches on the current best only —
    no islands, no crossover, no archive, no meta-recommendations.
    Returns (best, evals_to_best)."""
    rng = random.Random(seed)
    ev = CascadeEvaluator(w, mesh, hw)
    mut = HeuristicMutator()
    cur = Candidate(directive=CONSERVATIVE)
    cur.result = ev.evaluate(cur)
    best = cur
    evals_to_best = 1
    for g in range(gens * 3):          # same total evaluation budget
        ctx = MutationContext(parent=best, phase="exploit",
                              traits=w.traits(hw), tunable_space={})
        d, _ = mut.propose(ctx, rng)
        child = Candidate(directive=d, gen=g)
        child.result = ev.evaluate(child)
        if child.score > best.score * 1.0001:
            best = child
            evals_to_best = g + 2
    return best, evals_to_best


def run(device="cuda", *, chip=H100, mesh=None, measure=True, small=False,
        iters=5, out=None):
    del iters
    device = common.resolve_device(device)
    mesh = mesh or VirtualMesh(1, device=device)
    hw = extract_hardware_context(mesh, chip)
    gens = min(GENS, SMALL_GENS) if small else GENS
    w = _workload(mesh)
    rows = []
    t0 = time.perf_counter()

    # --- fig 9: naive vs CUCo -------------------------------------------
    seed = fast_path(w, mesh, hw)
    res_full = slow_path(seed, mesh, hw, SlowPathConfig(
        islands=3, generations=gens, seed=0))
    naive_best, naive_evals = naive_iterative(w, mesh, hw, gens)
    t_naive = naive_best.result.t_model_ms
    t_full = res_full.best.result.t_model_ms
    series = res_full.best_per_generation()
    gens_to_best = next((g for g, s in series
                         if s >= res_full.best.score * 0.999), gens)
    rows.append(("fig9/naive_prompting_ms", t_naive * 1e3,
                 f"best score {naive_best.score:.1f} after "
                 f"{naive_evals} evaluations"))
    rows.append(("fig9/cuco_ms", t_full * 1e3,
                 f"best score {res_full.best.score:.1f} by generation "
                 f"{gens_to_best} (paper: gen 3); speedup vs naive "
                 f"{t_naive / t_full:.3f}x"))

    # --- fig 10/11: fast-path + bounded-operator ablation -----------------
    rng = random.Random(42)
    no_fp_seed = dataclasses.replace(
        seed, directive=random_directive(rng, **w.traits(hw)))
    res_nofp = slow_path(no_fp_seed, mesh, hw,
                         SlowPathConfig(islands=3, generations=gens, seed=0),
                         mutator=HeuristicMutator(bounded=False))
    waste_fp = sum(1 for r in res_full.db.records
                   if not (r.result and r.result.ok)) / len(res_full.db.records)
    waste_no = sum(1 for r in res_nofp.db.records
                   if not (r.result and r.result.ok)) / len(res_nofp.db.records)
    rows.append(("fig10/with_fastpath_best", res_full.best.score,
                 f"wasted_evals={waste_fp * 100:.0f}%"))
    rows.append(("fig11/without_fastpath_unbounded_best",
                 res_nofp.best.score,
                 f"wasted_evals={waste_no * 100:.0f}% (paper: 25% budget "
                 "wasted without the correctness-first stage)"))

    # --- fig 12/13: explore-exploit schedule ------------------------------
    res_exploit = slow_path(seed, mesh, hw, SlowPathConfig(
        islands=3, generations=gens, explore_frac=0.0, seed=0))
    cov_2p = res_full.archive.coverage()
    cov_ex = res_exploit.archive.coverage()
    rows.append(("fig12/two_phase_best", res_full.best.score,
                 f"behaviors={cov_2p}"))
    rows.append(("fig13/exploit_only_best", res_exploit.best.score,
                 f"behaviors={cov_ex}; two-phase finds "
                 f"{cov_2p - cov_ex:+d} more behaviors"))
    if measure:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        evals = 1 + (gens * 3 + 1) + sum(
            len(r.db.records) for r in (res_full, res_nofp, res_exploit))
        rows.append(("fig9_13/wall_per_candidate_card", wall / evals * 1e6,
                     f"{evals} candidates through the {mesh.device.type} "
                     f"cascade ({mesh.n} ranks, {gens} generations) in "
                     f"{wall:.3f} s card={common.card_label(mesh.device)}"))
    return common.finish(rows, out)


if __name__ == "__main__":
    raise SystemExit(common.main(run, doc=__doc__))
