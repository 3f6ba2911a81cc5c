"""The port's fault model and the cascade's fault scoring against the JAX
package, on the CPU.

``repro_torch.core.faults`` copies ``repro/core/faults.py``: the plans,
``fault_cost`` and ``survival_report`` must equal the reference's within
1e-9 relative for every workload at every Table-3 point (``EXPERT_SYSTEMS``,
FLUX among them) and ``CONSERVATIVE``, under dropped-peer, straggler,
combined and no-survivor plans, both sides on the ``V5E`` context (the
reference has no ``H100``; the port's gets its own finiteness and ordering
checks). ``inject_wire_fault`` must mark the same elements on the same
numpy inputs. The cascade's ``fault_plans`` / ``fault_weight`` must give
the reference's ``fault_report``, score and ``fault_penalty_ms`` where
both packages run to level 3 here: the XLA points at one rank, and a
toy workload twin on each side at four ranks (the evaluator stub of the
reference's own ``tests/test_faults.py``). The degraded workloads reach
level 3 through the plain versions on 3 CPU ranks.
"""
import dataclasses
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.core import cascade as jcas
from repro.core import design_space as jds
from repro.core import faults as jf
from repro.core.hardware import V5E as JV5E
from repro.core.hardware import HardwareContext as JHW
from repro.workloads.base import Workload as JWorkload
from repro.workloads.gemm_allgather import GemmAllGather as JGA
from repro.workloads.kv_transfer import KVTransfer as JKV
from repro.workloads.moe_dispatch import MoEDispatch as JMoE
from repro.workloads.ring_attention import RingAttention as JRing
from repro.workloads.serving import ServingStep as JServing
from repro_torch.core import cascade as tcas
from repro_torch.core import design_space as tds
from repro_torch.core import faults as tf
from repro_torch.core.hardware import H100, V5E, HardwareContext
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.workloads.base import Workload as TWorkload
from repro_torch.workloads.gemm_allgather import GemmAllGather as TGA
from repro_torch.workloads.kv_transfer import KVTransfer as TKV
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.moe_dispatch import inputs_from_numpy
from repro_torch.workloads.ring_attention import RingAttention as TRing
from repro_torch.workloads.serving import ServingStep as TServing
from torch_port_helpers import numpy_inputs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

WORKLOADS = {"moe_dispatch": (JMoE, TMoE), "serving_step": (JServing,
                                                            TServing),
             "gemm_allgather": (JGA, TGA), "ring_attention": (JRing, TRing),
             "kv_transfer": (JKV, TKV)}
POINTS = dict(jds.EXPERT_SYSTEMS, CONSERVATIVE=jds.CONSERVATIVE)


def ctx(cls, chip, n):
    return cls(chip=chip, mesh_shape=(n,), mesh_axes=("x",),
               chips_per_pod=n, n_chips=n, has_dcn=False)


def plans(mod):
    """The same plans built from each package's classes."""
    S, P = mod.FaultSpec, mod.FaultPlan
    return (P("drop-rank-1", (S(mod.DROPPED_PEER, rank=1),)),
            P("straggler-8x100us", (S(mod.STRAGGLER, rank=2, rounds=8,
                                      delay_s=100e-6),)),
            P("drop-and-straggle", (S(mod.DROPPED_PEER, rank=3),
                                    S(mod.STRAGGLER, rank=0, rounds=3,
                                      delay_s=40e-6),
                                    S(mod.CORRUPT_WIRE, rows=2))),
            P("no-survivor", tuple(S(mod.DROPPED_PEER, rank=r)
                                   for r in range(4))),
            P("healthy"))


def close(got, want, rel=1e-9):
    return got == want or abs(got - want) <= rel * max(abs(want), 1e-30)


def test_fault_spec_validation_equal_reference():
    for kind in jf.FAULT_KINDS:
        assert tf.FaultSpec(kind).kind == jf.FaultSpec(kind).kind
    assert tf.FAULT_KINDS == jf.FAULT_KINDS
    assert tf.REMESH_OVERHEAD == jf.REMESH_OVERHEAD
    with pytest.raises(ValueError) as te:
        tf.FaultSpec("meteor-strike")
    with pytest.raises(ValueError) as je:
        jf.FaultSpec("meteor-strike")
    assert str(te.value) == str(je.value)


def test_plan_queries_equal_reference():
    for tp, jp in zip(plans(tf), plans(jf)):
        assert (tp.name, tp.healthy, tp.dropped()) \
            == (jp.name, jp.healthy, jp.dropped())
        for n in range(1, 6):
            assert tp.live_ranks(n) == jp.live_ranks(n)
        for c in (0, 1, 2, 3, 4, 8):
            assert close(tp.straggler_stall_s(c), jp.straggler_stall_s(c))
        assert [(f.kind, f.rank, f.rows) for f in tp.wire_faults()] \
            == [(f.kind, f.rank, f.rows) for f in jp.wire_faults()]
        assert hash(tp) == hash(tf.FaultPlan(tp.name, list(tp.faults)))


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_fault_cost_and_survival_report_equal_reference(name):
    jcls, tcls = WORKLOADS[name]
    jw, tw = jcls(), tcls()
    jhw, thw = ctx(JHW, JV5E, jw.n_dev), ctx(HardwareContext, V5E, tw.n_dev)
    for key, jd in POINTS.items():
        td = tds.directive_from_dict(jd.as_dict())
        for tp, jp in zip(plans(tf), plans(jf)):
            try:
                want = jf.fault_cost(jw, jd, jhw, jp)
            except ValueError as e:
                with pytest.raises(ValueError) as te:
                    tf.fault_cost(tw, td, thw, tp)
                assert str(te.value) == str(e)
            else:
                assert close(tf.fault_cost(tw, td, thw, tp), want), (key,
                                                                     tp.name)
        jrep = jf.survival_report(jw, jd, jhw, plans(jf))
        trep = tf.survival_report(tw, td, thw, plans(tf))
        assert list(trep) == list(jrep)
        for plan, je in jrep.items():
            te = trep[plan]
            assert set(te) == set(je) and te["survives"] == je["survives"]
            assert te.get("diagnostic") == je.get("diagnostic")
            for k in ("healthy_ms", "degraded_ms"):
                assert close(te[k], je[k]), (key, plan, k)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_fault_cost_on_the_h100_context(name):
    """The port's H100 model: a dropped peer costs more than the healthy
    step but stays finite; the straggler stall falls with the window; the
    no-survivor plan reports ``survives=False``."""
    w = WORKLOADS[name][1]()
    hw = ctx(HardwareContext, H100, w.n_dev)
    drop, strag, _, none, healthy = plans(tf)
    for d in (tds.EXPERT_SYSTEMS["FLUX"], tds.CONSERVATIVE):
        h = w.analytic_cost(d, hw)
        assert math.isfinite(h) and h > 0
        assert h < tf.fault_cost(w, d, hw, drop) < math.inf
        assert tf.fault_cost(w, d, hw, healthy) == h
    flux = tds.EXPERT_SYSTEMS["FLUX"]
    stalls = []
    for c in (1, 2, 4):
        d = dataclasses.replace(flux, contexts=c)
        stalls.append(tf.fault_cost(w, d, hw, strag) - w.analytic_cost(d, hw))
    assert stalls[0] > stalls[1] > stalls[2] > 0
    rep = tf.survival_report(w, flux, hw, (drop, none))
    assert rep["drop-rank-1"]["survives"]
    assert not rep["no-survivor"]["survives"]
    assert "non-empty" in rep["no-survivor"]["diagnostic"]


@pytest.mark.parametrize("kind", ["CORRUPT_WIRE", "TRUNCATED_WIRE"])
@pytest.mark.parametrize("rows", [1, 3, 64])
def test_inject_wire_fault_marks_the_same_elements(kind, rows):
    rng = np.random.default_rng(rows)
    arrs = {"a": rng.standard_normal((8, 4)).astype(np.float32),
            "b": rng.standard_normal((2, 5, 3)).astype(np.float32),
            "i": np.arange(6, dtype=np.int32).reshape(3, 2),
            "s": np.float32(1.5)}
    jout = jf.inject_wire_fault(
        ({k: jnp.asarray(v) for k, v in arrs.items()},
         jnp.asarray(arrs["a"])), jf.FaultSpec(getattr(jf, kind), rows=rows))
    tin = ({k: torch.from_numpy(np.asarray(v)) for k, v in arrs.items()},
           torch.from_numpy(arrs["a"]))
    before = [t.clone() for t in tin[0].values()]
    tout = tf.inject_wire_fault(tin, tf.FaultSpec(getattr(tf, kind),
                                                  rows=rows))
    pairs = [(tout[0][k], jout[0][k]) for k in arrs] + [(tout[1], jout[1])]
    for t, j in pairs:
        got, want = t.numpy(), np.asarray(j)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert all(torch.equal(b, a) for b, a in zip(before, tin[0].values()))
    with pytest.raises(ValueError, match="not a wire fault"):
        tf.inject_wire_fault(tin, tf.FaultSpec(tf.STRAGGLER))


# ------------------------------------------------- the cascade's fault plans


def jax_evaluator(jw, n, inputs, **kw):
    return jcas.CascadeEvaluator(jw, make_mesh((1,), ("x",)),
                                 ctx(JHW, JV5E, n), verify_inputs=inputs,
                                 **kw)


def torch_evaluator(tw, n, inputs, **kw):
    return tcas.CascadeEvaluator(tw, VirtualMesh(n, device="cpu"),
                                 ctx(HardwareContext, V5E, n),
                                 verify_inputs=inputs, **kw)


def same_result(jr, tr):
    assert (tr.level, tr.rejection) == (jr.level, jr.rejection)
    assert close(tr.score, jr.score)
    assert list(tr.fault_report) == list(jr.fault_report)
    for plan, je in jr.fault_report.items():
        te = tr.fault_report[plan]
        assert te["survives"] == je["survives"]
        assert te.get("diagnostic") == je.get("diagnostic")
        for k in ("healthy_ms", "degraded_ms"):
            assert close(te[k], je[k])
    assert close(tr.record.fault_penalty_ms, jr.record.fault_penalty_ms)
    want = jr.record.deterministic_dict()
    got = tr.record.deterministic_dict()
    assert got.pop("device") == "cpu"
    for k in ("score", "fault_penalty_ms", "t_model_ms"):
        assert close(got.pop(k), want.pop(k))
    assert got == want


@pytest.mark.parametrize("weight", [0.0, 0.5, 2.0])
@pytest.mark.parametrize("serving", [False, True])
def test_cascade_fault_scoring_equal_reference_for_xla_points(serving,
                                                              weight):
    """At one rank the reference runs its XLA points to level 3 here. A
    straggler plan adds its stall; dropping the only rank leaves no
    survivor, prices as +inf and, with a weight, zeroes the score at
    level 3."""
    arrs = numpy_inputs(1, 64, 64, 64, 64 if serving else 0, seed=1)
    jcls, tcls = (JServing, TServing) if serving else (JMoE, TMoE)
    kw = dict(n_dev=1, tokens_per_rank=64, d=64, f=64)
    if serving:
        kw["f_shared"] = 64
    for pick in ((1,), (1, 3)):
        jplans = tuple(plans(jf)[i] for i in pick)
        tplans = tuple(plans(tf)[i] for i in pick)
        jev = jax_evaluator(jcls(**kw), 1, tuple(jnp.asarray(a) for a in arrs),
                            fault_plans=jplans, fault_weight=weight)
        tev = torch_evaluator(tcls(**kw), 1,
                              inputs_from_numpy(*arrs, device="cpu"),
                              fault_plans=tplans, fault_weight=weight)
        for i, d in enumerate([jds.CONSERVATIVE,
                               jds.EXPERT_SYSTEMS["TokenWeave"]]):
            jr = jev.evaluate(jcas.Candidate(d, cid=i))
            tr = tev.evaluate(tcas.Candidate(
                tds.directive_from_dict(d.as_dict()), cid=i))
            assert jr.level == 3
            same_result(jr, tr)
            if weight and len(pick) == 2:
                assert tr.score == 0.0 and math.isinf(
                    tr.record.fault_penalty_ms)


class JToy(JWorkload):
    """The reference's evaluator stub: a workload of ``n_dev`` ranks that
    doubles its input and models 1 ms / n_dev."""
    name = "toy"

    def __init__(self, n_dev=4):
        self.n_dev = n_dev

    def check(self, d, hw=None):
        return []

    def reference(self, x):
        return x * 2.0

    def build(self, d, mesh):
        return lambda x: x * 2.0

    def analytic_cost(self, d, hw):
        return 1e-3 / self.n_dev

    def degrade(self, live_ranks):
        from repro.core.schedule import check_live
        live = check_live(live_ranks, self.n_dev)
        return self if len(live) == self.n_dev else JToy(len(live))

    def state_bytes_per_rank(self):
        return 10 * 2**20


class TToy(TWorkload):
    """The same stub in the port."""
    name = "toy"

    def __init__(self, n_dev=4):
        self.n_dev = n_dev

    def check(self, d, hw=None):
        return []

    def reference(self, x):
        return x * 2.0

    def build(self, d, mesh):
        return lambda x: x * 2.0

    def analytic_cost(self, d, hw):
        return 1e-3 / self.n_dev

    def degrade(self, live_ranks):
        from repro_torch.core.schedule import check_live
        live = check_live(live_ranks, self.n_dev)
        return self if len(live) == self.n_dev else TToy(len(live))

    def state_bytes_per_rank(self):
        return 10 * 2**20


@pytest.mark.parametrize("weight", [0.0, 1.0, 3.5])
def test_cascade_fault_scoring_equal_reference_under_the_stub(weight):
    """Four ranks under every plan: a dropped peer prices the degraded
    model plus recovery and remesh, and the fragility lowers the score."""
    x = np.ones((4, 4), np.float32)
    jev = jax_evaluator(JToy(), 4, (jnp.asarray(x),), fault_plans=plans(jf),
                        fault_weight=weight)
    tev = torch_evaluator(TToy(), 4, (torch.from_numpy(x),),
                          fault_plans=plans(tf), fault_weight=weight)
    for i, d in enumerate([jds.CONSERVATIVE, jds.EXPERT_SYSTEMS["FLUX"]]):
        jr = jev.evaluate(jcas.Candidate(d, cid=i))
        tr = tev.evaluate(tcas.Candidate(tds.directive_from_dict(
            d.as_dict()), cid=i))
        same_result(jr, tr)
    one = tuple(p for p in plans(tf) if p.name != "no-survivor")
    tev = torch_evaluator(TToy(), 4, (torch.from_numpy(x),),
                          fault_plans=one, fault_weight=weight)
    base = torch_evaluator(TToy(), 4, (torch.from_numpy(x),))
    r = tev.evaluate(tcas.Candidate(tds.CONSERVATIVE))
    r0 = base.evaluate(tcas.Candidate(tds.CONSERVATIVE))
    assert r.level == 3 and r.t_model_ms == r0.t_model_ms
    assert (r.score < r0.score) == bool(weight)
    assert r0.fault_report == {} and r0.record.fault_penalty_ms == 0.0


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_degraded_cascades_reach_level_3_through_the_plain_versions(name):
    w = {wl.name: wl for wl in chip_smoke.fault_workloads(small=True)}[name]
    drop = plans(tf)[0]
    dw = w.degrade(drop.live_ranks(w.n_dev))
    assert dw.n_dev == w.n_dev - 1
    mesh = VirtualMesh(dw.n_dev, device="cpu")
    ev = tcas.CascadeEvaluator(dw, mesh, ctx(HardwareContext, H100,
                                             dw.n_dev),
                               verify_inputs=chip_smoke.fault_inputs(
                                   dw, "cpu"))
    for d in tds.EXPERT_SYSTEMS.values():
        res = ev.evaluate(tcas.Candidate(d))
        assert res.level == 3, (d, res.diagnostic)


def test_chip_smoke_faults_on_the_cpu():
    counts, recs = chip_smoke.phase_faults(
        "cpu", chip_smoke.fault_workloads(small=True), iters=1)
    assert counts == {}          # the plain versions launch nothing
    assert [r["name"].split("/")[0] for r in recs] == [
        "moe_dispatch", "moe_dispatch", "gemm_allgather", "ring_attention"]
    # moe keys are (variant, n, ...), the others (kernel, variant, n, ...)
    ns = [r["_key"][1] if r["name"].startswith("moe") else r["_key"][2]
          for r in recs]
    assert ns == [3, 3, 3, 3] and {r["_path"] for r in recs} == {"faults"}
