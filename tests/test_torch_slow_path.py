"""The port's slow path and its modules against the JAX package, on the CPU.

``repro_torch.core`` copies ``meta``, ``archive``, ``database``,
``mutation``, ``SearchTelemetry`` and ``slow_path``. Both searches run
here under one evaluator stub: it scores a directive by a fixed function
of its ``directive_key`` and rejects a fixed subset, the same in both
packages, so everything the searches decide (proposals, novelty, folds,
migration, meta recommendations, telemetry) must come out equal. Stores
written by either package must load in the other with equal records.
The reference's own batched parity test fails on this tree (ROADMAP
queue 3), so sequential against batched is held inside the port, once
under the stub and once through the port's real ``CascadeEvaluator`` on a
small ``ServingStep``.
"""
import dataclasses
import hashlib
import importlib
import json
import random
import types

import pytest

from repro.core import archive as jarchive
from repro.core import cascade as jcas
from repro.core import database as jdb
from repro.core import design_space as jds
from repro.core import meta as jmeta
from repro.core import mutation as jmut
from repro.core.hardware import V5E as JV5E
from repro.core.hardware import HardwareContext as JHW
from repro.workloads.gemm_allgather import GemmAllGather as JGA
from repro.workloads.moe_dispatch import MoEDispatch as JMoE
from repro.workloads.serving import ServingStep as JServing
from repro_torch.core import SlowPathConfig, slow_path, transfer_seeds
from repro_torch.core import archive as tarchive
from repro_torch.core import cascade as tcas
from repro_torch.core import database as tdb
from repro_torch.core import design_space as tds
from repro_torch.core import meta as tmeta
from repro_torch.core import mutation as tmut
from repro_torch.core.fast_path import fast_path
from repro_torch.core.slow_path import _tunable_space as t_tunable_space
from repro_torch.core.hardware import V5E, HardwareContext
from repro_torch.core.telemetry import SearchTelemetry
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.workloads.gemm_allgather import GemmAllGather as TGA
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.serving import ServingStep as TServing

jslow = importlib.import_module("repro.core.slow_path")  # the module, not
# the function ``repro.core`` exports under the same name
SETTINGS = [(0, 3, 6), (5, 2, 9), (11, 4, 4)]
WORKLOADS = {"serving_step": (JServing, TServing),
             "moe_dispatch": (JMoE, TMoE),
             "gemm_allgather": (JGA, TGA)}


def ctx(hw_cls, spec, n=4):
    return hw_cls(chip=spec, mesh_shape=(n,), mesh_axes=("x",),
                  chips_per_pod=n, n_chips=n, has_dcn=False)


def side(jax_side):
    """The package's modules, context and workload classes."""
    if jax_side:
        return types.SimpleNamespace(
            cas=jcas, ds=jds, db=jdb, arch=jarchive, meta=jmeta, mut=jmut,
            slow=jslow.slow_path, cfg=jslow.SlowPathConfig,
            transfer=jslow.transfer_seeds, hw=ctx(JHW, JV5E), i=0)
    return types.SimpleNamespace(
        cas=tcas, ds=tds, db=tdb, arch=tarchive, meta=tmeta, mut=tmut,
        slow=slow_path, cfg=SlowPathConfig, transfer=transfer_seeds,
        hw=ctx(HardwareContext, V5E), i=1)


SIDES = (side(True), side(False))


def _hash(key):
    return int(hashlib.sha256(key.encode()).hexdigest()[:12], 16)


class StubEvaluator:
    """The same scores in both packages: a fixed function of the
    directive's key; one key in six fails at l2 with a mismatch."""

    def __init__(self, s):
        self.s = s
        self.calls = 0

    def evaluate(self, cand):
        self.calls += 1
        key = self.s.ds.directive_key(cand.directive)
        h = _hash(key)
        if h % 6 == 0:
            return self.s.cas.EvalResult(
                1, 0.0, diagnostic="l2 verify failed: rel err 1e-1",
                rejection="l2:mismatch")
        t_ms = 0.5 + (h % 997) / 100.0
        return self.s.cas.EvalResult(3, 10000.0 / (1.0 + t_ms),
                                     t_model_ms=t_ms,
                                     diagnostic=f"ok: modeled {t_ms:.3f} ms")

    def evaluate_batch(self, cands, max_workers=None):
        return [self.evaluate(c) for c in cands]


def run(s, wl_name, setting, **kw):
    seed_, islands, gens = setting
    wl = WORKLOADS[wl_name][s.i](n_dev=4)
    d = dataclasses.replace(s.ds.CONSERVATIVE, backend="PALLAS_RDMA",
                            tunables=tuple(sorted(
                                wl.default_tunables().items())))
    seed = types.SimpleNamespace(workload=wl, directive=d)
    kw.setdefault("evaluator", StubEvaluator(s))
    return s.slow(seed, None, s.hw, s.cfg(islands=islands, generations=gens,
                                          seed=seed_), **kw)


def summary(res):
    return {"history": res.history,
            "best": res.best.directive.as_dict(),
            "seed_score": res.seed_score,
            "payload": res.telemetry.payload(),
            "digests": res.meta.digests,
            "recommendations": res.meta.recommendations,
            "coverage": res.archive.coverage(),
            "per_gen": res.best_per_generation()}


@pytest.mark.parametrize("wl_name", sorted(WORKLOADS))
@pytest.mark.parametrize("setting", SETTINGS)
def test_slow_path_equal_reference_under_the_stub(wl_name, setting):
    want = summary(run(SIDES[0], wl_name, setting))
    got = summary(run(SIDES[1], wl_name, setting))
    assert got == want
    assert len(got["history"]) == setting[1] * (setting[2] + 1)
    assert got["payload"]["totals"]["ok"] < got["payload"]["totals"]["evals"]


@pytest.mark.parametrize("setting", SETTINGS)
def test_batched_equals_sequential_in_the_port(setting):
    seq = summary(run(SIDES[1], "serving_step", setting))
    bat = summary(run(SIDES[1], "serving_step", setting, batched=True,
                      eval_workers=3))
    assert bat == seq


def test_port_search_through_the_cascade_on_the_cpu():
    """The real port cascade on a small ServingStep: fast path, then the
    slow path sequential and batched; every candidate that passes l0 and
    l1 reaches level 3, and both modes agree record for record."""
    wl = TServing(n_dev=4, tokens_per_rank=16, d=64, f=64, f_shared=64)
    mesh = VirtualMesh(4, device="cpu")
    hw = ctx(HardwareContext, V5E)
    runs = []
    for batched in (False, True):
        ev = tcas.CascadeEvaluator(wl, mesh, hw, batch_workers=3)
        seed = fast_path(wl, mesh, hw, evaluator=ev)
        res = slow_path(seed, mesh, hw, SlowPathConfig(islands=3,
                                                       generations=3, seed=1),
                        evaluator=ev, batched=batched)
        assert not [r for r in ev.records if r.rejection.startswith("l2")]
        assert sum(r.level == 3 for r in ev.records) >= 6
        assert res.best.score >= res.seed_score > 0
        runs.append((res.history, res.telemetry.payload(),
                     [r.deterministic_dict() for r in ev.records]))
    assert runs[0] == runs[1]


# ------------------------------------------------------------- mutation


def _parents(s, wl_name, n=12):
    rng = random.Random(3)
    wl = WORKLOADS[wl_name][s.i](n_dev=4)
    traits = wl.traits(s.hw)
    diags = ["ok: modeled 1.000 ms", "l2 verify failed: non-finite values",
             "invalid directive: x", "l0 schedule verify failed: deadlock",
             "l1 build/lower failed"]
    out = []
    for i in range(n):
        d = s.ds.random_directive(rng, **traits)
        ok = i % len(diags) == 0
        c = s.cas.Candidate(directive=d, cid=i)
        c.result = s.cas.EvalResult(3 if ok else 1, 50.0 + i if ok else 0.0,
                                    diagnostic=diags[i % len(diags)])
        out.append(c)
    return wl, traits, out


@pytest.mark.parametrize("wl_name", sorted(WORKLOADS))
def test_heuristic_mutator_equal_reference(wl_name):
    """``propose`` over a corpus of contexts: every parent, both phases,
    with and without archive samples and recommendations, bounded and
    unbounded; the same directive and form for the same rng state."""
    outs = []
    for s in SIDES:
        wl, traits, parents = _parents(s, wl_name)
        space = (jslow._tunable_space if s.i == 0 else
                 t_tunable_space)(wl)
        recs = [[], [{"kind": "try_behavior", "backend": "PALLAS_RDMA",
                      "placement": "TILE_FUSED", "completion": "COUNTER"},
                     {"kind": "bottleneck", "which": "overhead"}]]
        got = []
        for k, parent in enumerate(parents):
            for phase in ("explore", "exploit"):
                for r in recs:
                    for bounded in (True, False):
                        c = s.mut.MutationContext(
                            parent=parent, phase=phase,
                            archive_samples=parents[k + 1:k + 3],
                            recommendations=r, hardware=s.hw, traits=traits,
                            tunable_space=space)
                        rng = random.Random(k * 100 + len(r))
                        d, form = s.mut.HeuristicMutator(bounded).propose(
                            c, rng)
                        got.append((d.as_dict(), form, rng.random()))
        outs.append(got)
    assert outs[1] == outs[0] and len(outs[0]) == 12 * 2 * 2 * 2


def test_parse_directive_and_prompt():
    d = jds.EXPERT_SYSTEMS["FLUX"].with_tunable("combine_tile", 16)
    td = tds.directive_from_dict(d.as_dict())
    text = d.render()
    assert tmut.parse_directive(text, tds.CONSERVATIVE).as_dict() \
        == jmut.parse_directive(text, jds.CONSERVATIVE).as_dict() \
        == d.as_dict()
    parent = tcas.Candidate(directive=td)
    prompt = tmut.LLMMutator().build_prompt(tmut.MutationContext(
        parent=parent, phase="explore", hardware=SIDES[1].hw))
    assert "GPU program" in prompt and "acquire" in prompt
    assert "TPU" not in prompt and "pltpu" not in prompt
    with pytest.raises(RuntimeError):
        tmut.LLMMutator().propose(tmut.MutationContext(parent=parent,
                                                       phase="explore"),
                                  random.Random(0))


# ------------------------------------------------------------------ meta


def test_meta_summarizer_equal_reference():
    outs = []
    for s in SIDES:
        _, _, parents = _parents(s, "serving_step", n=20)
        db = s.db.CandidateDB()
        meta = s.meta.MetaSummarizer(every=2)
        got = []
        for i, c in enumerate(parents):
            c.gen = i // 4
            db.add(c)
            meta.observe(c)
            if i % 4 == 3:
                got.append(meta.summarize(c.gen, db))
        outs.append((got, meta.scratchpad))
    assert outs[1] == outs[0]


# --------------------------------------------------------------- transfer


def _archive(s):
    """An archive of gemm_allgather elites from a stub search."""
    return run(s, "gemm_allgather", (2, 3, 6)).archive


def test_transfer_seeds_equal_reference():
    got = []
    for s in SIDES:
        target = WORKLOADS["moe_dispatch"][s.i](n_dev=4)
        seeds = s.transfer(_archive(s), target, hw=s.hw)
        got.append([d.as_dict() for d in seeds])
    assert got[1] == got[0] and len(got[0]) >= 2
    assert all("block_tokens" in d["tunables"] for d in got[0])


# ------------------------------------------------------------------ stores


def _records(db):
    return [json.dumps(tdb.candidate_to_dict(c), sort_keys=True)
            for c in db.records]


@pytest.mark.parametrize("writer", [0, 1])
def test_stores_cross_load_both_ways(tmp_path, writer):
    """A ``cuco-candidate-db`` and a ``cuco-map-elites`` store written by
    one package load in the other with equal records and cells."""
    w, r = SIDES[writer], SIDES[1 - writer]
    res = run(w, "serving_step", (4, 3, 5))
    wl = WORKLOADS["serving_step"][w.i](n_dev=4)
    db_path, ar_path = tmp_path / "db.json", tmp_path / "archive.json"
    res.db.save(str(db_path), workload=wl.fingerprint(),
                hardware=w.hw.fingerprint)
    res.archive.save(str(ar_path), workload=wl.fingerprint(),
                     hardware=w.hw.fingerprint)
    db = r.db.CandidateDB.load(str(db_path))
    assert _records(db) == _records(res.db)
    assert db.history() == res.db.history()
    assert db.saved_meta == {"workload": wl.fingerprint(),
                             "hardware": w.hw.fingerprint}
    assert [list(e) for e in db.embeddings] == [
        [round(float(x), 7) for x in e] for e in res.db.embeddings]
    ar = r.arch.MapElitesArchive.load(str(ar_path))
    assert sorted(ar.cells) == sorted(res.archive.cells)
    assert [tdb.candidate_to_dict(c) for c in ar.elites()] \
        == [tdb.candidate_to_dict(c) for c in res.archive.elites()]
    with pytest.raises(r.db.StoreError):
        r.arch.MapElitesArchive.load(str(db_path))     # wrong store kind


def test_bad_store_gives_a_cold_start(tmp_path):
    s = SIDES[1]
    setting = (0, 2, 3)
    store = tmp_path / "db.json"
    cold = run(s, "serving_step", setting, save_to=str(store))
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{definitely not json")
    mismatch = tmp_path / "mismatch.json"
    payload = json.loads(store.read_text())
    payload["version"] = 999
    mismatch.write_text(json.dumps(payload))
    for bad in (corrupt, mismatch, tmp_path / "missing.json"):
        got = run(s, "serving_step", setting, warm_start=str(bad))
        assert got.telemetry.scale == {"warm_start": False, "cache_hits": 0,
                                       "transferred_seeds": 0}
        assert got.history == cold.history
    with pytest.raises(tdb.StoreError):
        tdb.CandidateDB.load(str(corrupt))
    with pytest.raises(tdb.StoreError):
        tdb.CandidateDB.load(str(mismatch))


@pytest.mark.parametrize("writer", [0, 1])
def test_warm_start_serves_the_cache_and_transfers(tmp_path, writer):
    """A matching store written by either package seeds the port's warm
    start from cache (the two packages fingerprint alike); a store of
    another workload transfers its elites and re-evaluates them."""
    store = tmp_path / "db.json"
    run(SIDES[writer], "serving_step", (1, 3, 4), save_to=str(store))
    ev = StubEvaluator(SIDES[1])
    warm = run(SIDES[1], "serving_step", (1, 3, 2), warm_start=str(store),
               evaluator=ev)
    hits = warm.telemetry.payload()["scale"]["cache_hits"]
    assert warm.telemetry.scale["warm_start"] is True and hits > 0
    assert ev.calls == len(warm.db.records) - hits
    other = tmp_path / "other.json"
    run(SIDES[writer], "gemm_allgather", (1, 3, 4), save_to=str(other))
    moved = run(SIDES[1], "moe_dispatch", (1, 3, 2), warm_start=str(other))
    scale = moved.telemetry.scale
    assert scale["cache_hits"] == 0 and scale["transferred_seeds"] > 0


def test_search_telemetry_payload_equal_reference():
    """``SearchTelemetry`` over the same EvalRecords gives the reference's
    payload, series and win stats."""
    from repro.core.telemetry import EvalRecord as JRec
    from repro.core.telemetry import SearchTelemetry as JTel
    from repro_torch.core.telemetry import EvalRecord as TRec
    rng = random.Random(9)
    rows = [dict(cid=i, gen=i // 3, island=i % 3,
                 mutation=rng.choice(["diff", "rewrite", "crossover"]),
                 directive=f"d{i}", level=rng.choice([0, 1, 3, 3]),
                 score=rng.random() * 100, t_model_ms=rng.random(),
                 retries=rng.choice([0, 0, 1]),
                 quarantined=rng.random() < 0.1,
                 knobs={"block_tokens": 64})
            for i in range(15)]
    tels = []
    for cls, rec in ((JTel, JRec), (SearchTelemetry, TRec)):
        tel = cls("serving_step")
        for row in rows:
            tel.observe(rec(**row))
        for g in range(5):
            tel.note_coverage(g, g + 1)
        tel.note_scale(warm_start=True, cache_hits=2)
        tels.append(tel.payload({"note": "x"}))
    assert tels[1] == tels[0]


def test_chip_smoke_slow_main_on_the_cpu():
    """The smoke's slow_main phase at test size on the CPU (the plain
    version, so no launch is counted): the search, its checks and the
    warm start from the saved store; the full size is ServingStep at
    DeepSeek-V3 width."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    assert chip_smoke.phase_slow_main(
        "cpu", chip_smoke.slow_workload(small=True)) == {}
    assert chip_smoke.store_path().exists()
    w = chip_smoke.slow_workload()
    assert (w.n_dev, w.d, w.f, w.f_shared) == (4, 7168, 2048, 2048)
