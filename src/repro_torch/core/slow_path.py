"""Slow-path agent: multi-island evolutionary search, Algorithm 1 (paper
§3.3, Appendix E/H) with explore->exploit phase scheduling, MAP-Elites
cross-pollination, embedding-guided candidate DB with novelty filtering,
periodic migration, and the meta-summarizer feedback loop.

Scaled search (the reference's docs/search.md): each generation
proposes all islands' children first — against the end-of-previous-
generation db/archive state, with an intra-generation ``pending`` key set
standing in for the novelty the not-yet-folded siblings would provide —
then evaluates them as one batch, then folds results in island order. The
proposal/evaluate/fold phases are identical whether evaluation runs
sequentially or through ``CascadeEvaluator.evaluate_batch`` (the
``batched=`` flag), so the two modes produce the same ``db.history()`` and
byte-identical telemetry payloads by construction.

Warm start: ``slow_path(..., warm_start=path)`` loads a persisted
``CandidateDB`` or ``MapElitesArchive`` store. If the store's workload +
hardware fingerprints match this run's, generation zero is seeded from the
loaded elites, the archive is pre-populated with them (resumed coverage
can only grow), and any directive already evaluated in the store is served
from cache instead of re-running the cascade (cache key =
``directive_key`` scoped by the two fingerprints). A mismatched store
falls back to :func:`transfer_seeds` — elite directives mapped onto the
target workload's tunable grids, validity-repaired, and re-evaluated from
scratch. A corrupt or version-mismatched store degrades to a clean cold
start. ``save_to=path`` persists the finished run's db for the next one.

Port copy of ``repro/core/slow_path.py``: the same proposals, folds and
stores for the same seed. The default evaluator is the port's
:class:`~repro_torch.core.cascade.CascadeEvaluator`; on a card,
``batched=True`` goes through its ``evaluate_batch``, which runs the
generation's l2 executions on one stream, one after another (two
persistent spin-waiting kernels on two streams could starve each other).
"""
from __future__ import annotations

import dataclasses
import math
import random
from dataclasses import dataclass, field

from repro_torch.core.archive import MapElitesArchive
from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.database import CandidateDB, StoreError
from repro_torch.core.design_space import TUNABLES, Directive, directive_key, \
    is_valid, random_directive
from repro_torch.core.meta import MetaSummarizer
from repro_torch.core.mutation import HeuristicMutator, MutationContext
from repro_torch.core.telemetry import SearchTelemetry

# the tile-shaped knob alias family (all sanitized by
# core/schedule.py::sanitize_tile at the consumer boundary): a tuned value
# for any of these carries a transferable "preferred tile size" signal
# that transfer_seeds maps onto whichever of them the target workload has.
TILE_KNOBS = ("block_tokens", "combine_tile", "kv_chunk", "tile_m")


@dataclass
class SlowPathConfig:
    islands: int = 3
    generations: int = 12
    explore_frac: float = 0.4        # paper §4.4: 40% explore then exploit
    migration_every: int = 4
    migration_k: int = 1
    selection_pressure: float = 2.0
    seed: int = 0
    meta_every: int = 3


@dataclass
class Island:
    idx: int
    population: list = field(default_factory=list)

    def select(self, rng, pressure):
        """Fitness-weighted sampling (softmax over score with pressure)."""
        alive = [c for c in self.population if c.result is not None]
        if not alive:
            return None
        mx = max(c.score for c in alive)
        ws = [math.exp(pressure * (c.score - mx) / max(1.0, mx or 1.0))
              for c in alive]
        return rng.choices(alive, weights=ws)[0]


@dataclass
class SearchResult:
    best: Candidate
    db: CandidateDB
    archive: MapElitesArchive
    meta: MetaSummarizer
    seed_score: float
    history: list
    # per-generation/per-island series + mutation win rates aggregated from
    # the cascade's EvalRecords (core/telemetry.py::SearchTelemetry); the
    # source of the BENCH_search.json artifact
    telemetry: object = None

    def best_per_generation(self):
        out = {}
        for r in self.db.records:
            if r.result and r.result.ok:
                out[r.gen] = max(out.get(r.gen, 0.0), r.score)
        best = 0.0
        series = []
        for g in sorted(out):
            best = max(best, out[g])
            series.append((g, best))
        return series


def slow_path(seed, mesh, hw, cfg: SlowPathConfig = None, *,
              mutator=None, evaluator=None, verbose=False, batched=False,
              eval_workers=None, warm_start=None,
              save_to=None) -> SearchResult:
    """seed: VerifiedSeed from the fast path (generation zero).

    ``batched=True`` routes each generation's evaluations through
    ``evaluator.evaluate_batch`` (``eval_workers`` bounds the pool);
    ``warm_start``/``save_to`` load/persist the search store (module
    docstring)."""
    cfg = cfg or SlowPathConfig()
    rng = random.Random(cfg.seed)
    wl = seed.workload
    ev = evaluator or CascadeEvaluator(wl, mesh, hw)
    mut = mutator or HeuristicMutator()
    db = CandidateDB()
    archive = MapElitesArchive()
    meta = MetaSummarizer(every=cfg.meta_every)
    traits = wl.traits(hw)
    tun_space = _tunable_space(wl)
    scale = {"warm_start": False, "cache_hits": 0, "transferred_seeds": 0}

    warm = _load_warm_start(warm_start, wl, hw) if warm_start else None
    cache = warm["cache"] if warm else {}
    if warm:
        scale["warm_start"] = True
        scale["transferred_seeds"] = warm["transferred"]
        for c in warm["prewarm"]:      # saved cells re-offered: coverage
            archive.offer(c)           # resumes >= where it left off

    def eval_all(cands):
        """The one evaluation point for a proposed generation: cache hits
        (warm start) are served without touching the evaluator; misses run
        sequentially or as one bounded-pool batch — result streams
        identical either way (cascade parity contract)."""
        misses = []
        for c in cands:
            hit = cache.get(directive_key(c.directive))
            if hit is not None:
                c.result = dataclasses.replace(hit)
                c.cached = True
                scale["cache_hits"] += 1
            else:
                misses.append(c)
        if batched and hasattr(ev, "evaluate_batch"):
            for c, r in zip(misses,
                            ev.evaluate_batch(misses,
                                              max_workers=eval_workers)):
                c.result = r
        else:
            for c in misses:
                c.result = ev.evaluate(c)

    # island initialization: distinct seeds = semantically different variants
    # of the fast-path baseline drawn from C (paper Appendix E); a warm
    # start replaces the random variants with loaded/transferred elites
    # (which keep their own tuned tunables)
    islands = [Island(idx=i) for i in range(cfg.islands)]
    gen0 = []
    warm_seeds = list(warm["seeds"]) if warm else []
    used = {directive_key(seed.directive)}
    for isl in islands:
        label = "island-seed"
        if isl.idx == 0:
            d = seed.directive
        else:
            d = None
            while warm_seeds:
                s = warm_seeds.pop(0)
                if directive_key(s) not in used:
                    d = s
                    label = "transfer-seed" if warm["transferred"] \
                        else "warm-seed"
                    break
            if d is None:
                d = random_directive(rng, **traits)
        if label == "island-seed":
            d = dataclasses.replace(d, tunables=seed.directive.tunables)
        used.add(directive_key(d))
        gen0.append(Candidate(directive=d, gen=0, island=isl.idx,
                              mutation=label))
    eval_all(gen0)
    for isl, cand in zip(islands, gen0):
        db.add(cand)
        archive.offer(cand)
        meta.observe(cand)
        isl.population.append(cand)
    seed_score = islands[0].population[0].score
    coverage = {0: archive.coverage()}     # per-gen archive coverage series

    recommendations = []
    for gen in range(1, cfg.generations + 1):
        phase = "explore" if gen <= cfg.explore_frac * cfg.generations \
            else "exploit"
        # -- propose: every island's child, against end-of-last-generation
        # state; ``pending`` carries intra-generation novelty
        proposals = []
        pending = set()
        for isl in islands:
            parent = isl.select(rng, cfg.selection_pressure)
            if parent is None:
                continue
            ctx = MutationContext(
                parent=parent, phase=phase,
                archive_samples=archive.sample(
                    rng, 2, exclude_behavior=parent.directive.behavior),
                neighbors=db.knn(parent, 3),
                recommendations=recommendations,
                hardware=hw, traits=traits, tunable_space=tun_space)
            d, form = mut.propose(ctx, rng)
            if not db.is_novel(d) or directive_key(d) in pending:
                d, form = mut.propose(ctx, rng)    # novelty filter: resample
                if not db.is_novel(d) or directive_key(d) in pending:
                    d = random_directive(rng, **traits)
                    form = "novelty-resample"
            pending.add(directive_key(d))
            proposals.append(
                (isl, Candidate(directive=d, gen=gen, island=isl.idx,
                                parent_id=parent.cid, mutation=form)))
        # -- evaluate: the whole generation at once (cascade l1 -> l2 -> l3)
        eval_all([child for _, child in proposals])
        # -- fold in: island order, exactly as the sequential loop did
        for isl, child in proposals:
            db.add(child)
            archive.offer(child)
            meta.observe(child)
            isl.population.append(child)
            if len(isl.population) > 8:            # bounded population
                isl.population.sort(key=lambda c: -c.score)
                isl.population = isl.population[:8]
            if verbose:
                print(f"g{gen} i{isl.idx} {child.mutation:16s} "
                      f"{child.directive.backend[:5]}/"
                      f"{child.directive.placement[:14]} "
                      f"score={child.score:8.2f} [{phase}]")
        # migration: top-k of each island copied into a random other island
        if gen % cfg.migration_every == 0:
            for isl in islands:
                top = sorted(isl.population, key=lambda c: -c.score)
                for t in top[:cfg.migration_k]:
                    dst = rng.choice([j for j in islands if j.idx != isl.idx])
                    dst.population.append(t)
        if gen % cfg.meta_every == 0:
            _, recommendations = meta.summarize(gen, db)
        coverage[gen] = archive.coverage()

    best = db.best
    telemetry = SearchTelemetry.from_candidates(
        db.records, workload=wl.name, coverage=coverage)
    telemetry.note_scale(**scale)
    if save_to:
        db.save(save_to, workload=wl.fingerprint(), hardware=hw.fingerprint)
    return SearchResult(best=best, db=db, archive=archive, meta=meta,
                        seed_score=seed_score, history=db.history(),
                        telemetry=telemetry)


# -------------------------------------------------- warm start and transfer


def _load_warm_start(path, wl, hw):
    """Resolve a warm-start store into gen-0 seeds, an eval cache, and
    archive pre-population. Accepts either store kind (db or archive).
    Returns ``None`` — a clean cold start — when the store is missing,
    corrupt, version-mismatched, or empty; the search must never die on a
    bad store it was merely offered."""
    try:
        try:
            store_db = CandidateDB.load(path)
            meta_fp = store_db.saved_meta
            elite_arch = MapElitesArchive()
            for r in store_db.records:
                elite_arch.offer(r)
            cache_src = [r for r in store_db.records if r.result is not None]
        except StoreError:
            elite_arch = MapElitesArchive.load(path)
            meta_fp = elite_arch.saved_meta
            cache_src = list(elite_arch.cells.values())
        elites = elite_arch.elites()
        matched = (meta_fp.get("workload") == wl.fingerprint()
                   and meta_fp.get("hardware") == hw.fingerprint)
        if matched:
            seeds = [c.directive for c in elites]
            cache = {directive_key(c.directive): c.result
                     for c in cache_src}
            prewarm, transferred = elites, 0
        else:
            seeds = transfer_seeds(elite_arch, wl, hw=hw)
            cache, prewarm, transferred = {}, [], len(seeds)
        if not seeds:
            return None
        return {"seeds": seeds, "cache": cache, "prewarm": prewarm,
                "transferred": transferred}
    except Exception:
        return None


def transfer_seeds(archive, target_wl, hw=None, limit=None):
    """Map a tuned archive's elites onto another workload (docs/search.md):
    for each elite, keep every tunable the target also exposes, carry the
    elite's tile-size signal across the ``sanitize_tile`` alias family
    (``block_tokens``/``combine_tile``/``kv_chunk``/``tile_m`` — snapped to
    the target knob's grid), fill the rest from the target's defaults, and
    validity-repair the dimensions against the target's traits with a
    fixed substitution ladder. Deduped by ``directive_key``, ordered by
    source score. These seed generation zero of a cross-workload warm
    start; they are always re-evaluated (a cached score never crosses a
    fingerprint boundary)."""
    traits = target_wl.traits(hw)
    defaults = target_wl.default_tunables()
    out, seen = [], set()
    for elite in archive.elites():
        src = dict(elite.directive.tunables)
        tile = next((src[n] for n in TILE_KNOBS
                     if isinstance(src.get(n), int)), None)
        tun = {}
        for name, dv in sorted(defaults.items()):
            if name in src:
                tun[name] = src[name]
            elif name in TILE_KNOBS and tile is not None:
                tun[name] = _snap(tile, TUNABLES.get(name))
            elif dv is not None:
                tun[name] = dv
        d = dataclasses.replace(elite.directive,
                                tunables=tuple(sorted(tun.items())))
        d = _repair(d, traits)
        k = directive_key(d)
        if k in seen:
            continue
        seen.add(k)
        out.append(d)
        if limit and len(out) >= limit:
            break
    return out


def _snap(value, grid):
    """Nearest grid point (deterministic: ties go to the smaller knob)."""
    if not grid:
        return value
    return min(grid, key=lambda g: (abs(g - value), g))


def _repair(d: Directive, traits) -> Directive:
    """Deterministic validity ladder for a transferred directive: try the
    mapped point, then progressively safer substitutions, ending at the
    always-valid conservative coordinates (tunables kept throughout)."""
    trials = (
        d,
        dataclasses.replace(d, scope="LOCAL"),
        dataclasses.replace(d, scope="LOCAL", granularity="PER_TILE"),
        dataclasses.replace(d, scope="LOCAL", granularity="PER_TILE",
                            contexts=max(2, d.contexts)),
        dataclasses.replace(d, backend="XLA_COLLECTIVE",
                            completion="BARRIER", placement="DEFERRED",
                            issuer="KERNEL", scope="WORLD",
                            granularity="PER_PEER", ordering="RELEASE",
                            contexts=1),
    )
    for t in trials:
        if is_valid(t, **traits):
            return t
    return trials[-1]


def _tunable_space(wl):
    """Diff-patch candidate grids: the central design-space registry for
    known knobs (block_tokens, combine_tile, tile_m, kv_chunk, chained,
    tight, wire_i8 — any workload ``default_tunables()`` name found in
    ``TUNABLES``), a geometric grid for workload-specific integers, plus
    the ``contexts`` dimension mirror — always refinable, so fine-grained
    mutations can retune the send-window depth of a kernelized point
    without a placement move. Tile-shaped knobs are sanitized by their
    consumers (``core/schedule.py::sanitize_tile``), so any grid value is
    safe to propose."""
    defaults = wl.default_tunables()
    space = {}
    for name, v in defaults.items():
        if name in TUNABLES:
            space[name] = TUNABLES[name]
        elif isinstance(v, int) and v > 1:
            space[name] = tuple(sorted({max(1, v // 4), max(1, v // 2), v,
                                        v * 2, v * 4}))
    space.setdefault("contexts", TUNABLES["contexts"])
    return space
