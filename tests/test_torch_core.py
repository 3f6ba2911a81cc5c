"""The port's copies of the jax-free modules against the reference.

``repro_torch`` keeps its own copies of ``core/design_space.py``,
``core/schedule.py``, ``core/verify.py`` and the workloads' l3 cost
models; these tests hold each copy equal to ``repro``'s over grids of
inputs (exact equality: the copies do the same arithmetic in the same
order). The subprocess guard proves the port imports neither ``jax`` nor
any ``repro`` module.
"""
import dataclasses
import itertools
import os
import subprocess
import sys

import pytest

from repro.core import design_space as jds
from repro.core import schedule as jsch
from repro.core import verify as jver
from repro.core.hardware import V5E as JV5E
from repro.core.hardware import HardwareContext as JHW
from repro.workloads.moe_dispatch import MoEDispatch as JMoE
from repro.workloads.serving import ServingStep as JServing
from repro_torch.core import design_space as tds
from repro_torch.core import schedule as tsch
from repro_torch.core import verify as tver
from repro_torch.core.hardware import H100, V5E, HardwareContext
from repro_torch.core.hardware import extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.serving import ServingStep as TServing

ROOT = os.path.join(os.path.dirname(__file__), "..")

TRAITS = [dict(kernelizable=k, ring_topology=r, has_dcn=h)
          for k, r, h in itertools.product((False, True), repeat=3)]


# ------------------------------------------------------------- design space


@pytest.mark.parametrize("traits", TRAITS, ids=str)
def test_enumerate_valid_equal(traits):
    j = [d.as_dict() for d in jds.enumerate_valid(**traits)]
    t = [d.as_dict() for d in tds.enumerate_valid(**traits)]
    assert j == t and t


def test_directive_vocabulary_equal():
    assert tds.TUNABLES == jds.TUNABLES
    assert tds.DIMENSIONS == jds.DIMENSIONS
    assert tds.CONSERVATIVE.as_dict() == jds.CONSERVATIVE.as_dict()
    assert list(tds.EXPERT_SYSTEMS) == list(jds.EXPERT_SYSTEMS)
    for name, d in jds.EXPERT_SYSTEMS.items():
        td = tds.EXPERT_SYSTEMS[name]
        assert tds.directive_key(td) == jds.directive_key(d)
        assert repr(td) == repr(d)
        back = tds.directive_from_dict(d.as_dict())
        assert tds.directive_key(back) == jds.directive_key(d)
    d = jds.EXPERT_SYSTEMS["FLUX"].with_tunable("wire_i8", 1)
    td = tds.EXPERT_SYSTEMS["FLUX"].with_tunable("wire_i8", 1)
    assert tds.directive_key(td) == jds.directive_key(d)
    assert td.render() == d.render()


# ----------------------------------------------------------------- schedule

GRID = list(itertools.product(
    [(174, 57, 19, 6), (64, 64, 64, 64), (96, 64, 33, 17), (0, 5, 200, 51),
     (256,), (130, 126)],
    [16, 64, 128],
    [True, False]))


def _sched_view(s):
    return (s.n, s.block_tokens, s.counts, s.blocks, s.tight, s.b_max,
            s.rounds)


@pytest.mark.parametrize("counts,B,tight", GRID)
def test_dispatch_schedule_equal(counts, B, tight):
    j = jsch.make_schedule(counts, B, tight)
    t = tsch.make_schedule(counts, B, tight)
    assert _sched_view(t) == _sched_view(j)
    n = len(counts)
    for elide in (False, True):
        assert t.issued_rounds(elide) == j.issued_rounds(elide)
        for r in range(n):
            assert t.combine_issued_rounds(r, elide) \
                == j.combine_issued_rounds(r, elide)
            for ct in (None, 8, 16, 24, 64, 300):
                assert t.combine_ticks(ct, r, elide) \
                    == j.combine_ticks(ct, r, elide)
    for r in range(n):
        assert t.wire_tokens(r) == j.wire_tokens(r)
        assert t.executed_wire_tokens(r) == j.executed_wire_tokens(r)
        assert t.dummy_wire_tokens(r) == j.dummy_wire_tokens(r)
    for cx in (1, 2, 3, 4):
        assert t.send_window_depths(cx) == j.send_window_depths(cx)
    for k in range(1, n + 1):
        for live in itertools.combinations(range(n), k):
            assert _sched_view(t.degrade(live)) == _sched_view(j.degrade(live))
            for cf in (1.0, 1.25, 2.0):
                assert tsch.respill_counts(counts, live, cf) \
                    == jsch.respill_counts(counts, live, cf)


@pytest.mark.parametrize("n,rows,tile,fused", list(itertools.product(
    [2, 4, 8], [64, 96, 256], [16, 48, 128], [True, False])))
def test_broadcast_and_ring_schedules_equal(n, rows, tile, fused):
    jb = jsch.make_broadcast_schedule(n, rows, tile, fused)
    tb = tsch.make_broadcast_schedule(n, rows, tile, fused)
    assert dataclasses.astuple(tb) == dataclasses.astuple(jb)
    assert tb.rounds == jb.rounds
    jr = jsch.make_ring_schedule(n, rows, tile, fused)
    tr = tsch.make_ring_schedule(n, rows, tile, fused)
    assert dataclasses.astuple(tr) == dataclasses.astuple(jr)
    for counter in (True, False):
        assert tb.completion_ticks(counter) == jb.completion_ticks(counter)
        assert tr.completion_ticks(counter) == jr.completion_ticks(counter)
    for cx in (1, 2, 4):
        assert tb.send_window_depths(cx) == jb.send_window_depths(cx)
        assert tr.send_window_depths(cx) == jr.send_window_depths(cx)
    live = tuple(range(0, n, 2)) or (0,)
    assert dataclasses.astuple(tb.degrade(live)) \
        == dataclasses.astuple(jb.degrade(live))
    assert dataclasses.astuple(tr.degrade(live)) \
        == dataclasses.astuple(jr.degrade(live))
    for t in (3, 7, 64, None):
        assert tsch.sanitize_tile(t, rows) == jsch.sanitize_tile(t, rows)


def test_sem_slot_is_sender_driven():
    # flag words are bumped by the sender: slot = the issuing rank
    for me in range(4):
        for src in range(4):
            assert tsch.sem_slot(me, src) == me


# ------------------------------------------------------------------ verify


def _report_view(rep):
    if rep is None:
        return None
    return (rep.ok, rep.subject, rep.checked,
            tuple((e.code, e.rank, e.op_index, e.detail) for e in rep.errors))


def _program_view(p):
    return (p.n, p.contexts, p.live, p.edge_rows, p.subject,
            [[dataclasses.astuple(op) for op in ops] for ops in p.ops])


@pytest.mark.parametrize("counts,B,tight", [
    ((174, 57, 19, 6), 64, True), ((96, 64, 33, 17), 32, True),
    ((64, 64, 64, 64), 64, False), ((130, 126), 16, True)])
def test_lower_dispatch_equal(counts, B, tight):
    j = jsch.make_schedule(counts, B, tight)
    t = tsch.make_schedule(counts, B, tight)
    for cx in (1, 2, 4):
        for kw in (dict(), dict(barrier=True, pipelined=False),
                   dict(pipelined=False), dict(tile_fused=True),
                   dict(tile_fused=True, combine_tile=16, wire_i8=True)):
            jp = jver.lower_dispatch(j, cx, **kw)
            tp = tver.lower_dispatch(t, cx, **kw)
            assert _program_view(tp) == _program_view(jp)
            assert _report_view(tver.verify_program(tp)) \
                == _report_view(jver.verify_program(jp))


def test_mutation_corpus_equal():
    jc, tc = jver.mutation_corpus(), tver.mutation_corpus()
    assert [e["cls"] for e in tc] == [e["cls"] for e in jc]
    for je, te in zip(jc, tc):
        assert _report_view(te["run"]()) == _report_view(je["run"]())
        assert te["expect"] in te["run"]().codes()


def _kernel_directives(w):
    traits = dict(kernelizable=True, ring_topology=False, has_dcn=False)
    out = [d for d in jds.enumerate_valid(**traits)
           if d.backend == "PALLAS_RDMA" and d.scope == "LOCAL"
           and d.ordering == "ACQUIRE" and d.issuer == "GRID_STEP"]
    out += [jds.EXPERT_SYSTEMS["FLUX"].with_tunable("combine_tile", 16),
            jds.EXPERT_SYSTEMS["FLUX"].with_tunable("wire_i8", 1),
            jds.EXPERT_SYSTEMS["DeepEP (NVL)"].with_tunable("block_tokens", 32)]
    return out


@pytest.mark.parametrize("pair", ["moe", "serving"])
def test_verify_directive_equal(pair):
    jw, tw = ((JMoE(n_dev=4, tokens_per_rank=256), TMoE(n_dev=4,
                                                        tokens_per_rank=256))
              if pair == "moe" else (JServing(), TServing()))
    for d in _kernel_directives(jw):
        td = tds.directive_from_dict(d.as_dict())
        assert _report_view(tver.verify_directive(tw, td)) \
            == _report_view(jver.verify_directive(jw, d)), d


# --------------------------------------------------------------- cost model

JCTX = JHW(chip=JV5E, mesh_shape=(4,), mesh_axes=("x",), chips_per_pod=4,
           n_chips=4, has_dcn=False)
TCTX = HardwareContext(chip=V5E, mesh_shape=(4,), mesh_axes=("x",),
                       chips_per_pod=4, n_chips=4, has_dcn=False)


def _cost_view(cb):
    sched = cb.schedule
    return ([(s.name, s.dur_s, s.kind, s.meta) for s in cb.segments],
            cb.knobs, cb.meta, cb.total,
            None if sched is None else _sched_view(sched))


@pytest.mark.parametrize("pair", ["moe", "moe_t256", "serving"])
def test_cost_breakdown_equal_on_v5e(pair):
    jw, tw = {"moe": (JMoE(), TMoE()),
              "moe_t256": (JMoE(tokens_per_rank=256, skew=5.0),
                           TMoE(tokens_per_rank=256, skew=5.0)),
              "serving": (JServing(), TServing())}[pair]
    traits = jw.traits(JCTX)
    n = 0
    for i, d in enumerate(jds.enumerate_valid(**traits)):
        # every valid directive bare; every fifth also with tunables
        for tun in ((), (("wire_i8", 1),), (("block_tokens", 32),
                                           ("combine_tile", 16))):
            if tun and i % 5:
                continue
            d2 = dataclasses.replace(d, tunables=tun)
            td = tds.directive_from_dict(d2.as_dict())
            assert _cost_view(tw.cost_breakdown(td, TCTX)) \
                == _cost_view(jw.cost_breakdown(d2, JCTX)), d2
            assert tw.kernel_knobs(td) == jw.kernel_knobs(d2)
            assert tw.check(td, TCTX) == jw.check(d2, JCTX)
            n += 1
    assert n > 1000


def test_degraded_workloads_equal():
    for jw, tw in ((JMoE(), TMoE()), (JServing(), TServing())):
        for live in ((0, 1, 3), (1, 2), (2,)):
            jd, td = jw.degrade(live), tw.degrade(live)
            assert td.fingerprint() == jd.fingerprint()
            assert list(td._counts(td.T)) == list(jd._counts(jd.T))
            assert td.state_bytes_per_rank() == jd.state_bytes_per_rank()


def test_h100_spec_and_context():
    assert H100.peak_bf16_flops == 989e12
    assert H100.hbm_bw == 3.35e12
    assert H100.ici_link_bw == 450e9
    assert H100.hbm_bytes == 80 * 2**30
    assert dataclasses.astuple(V5E) == dataclasses.astuple(JV5E)
    hw = extract_hardware_context(VirtualMesh(4, device="cpu"))
    assert hw.chip is H100 and hw.n_chips == 4 and not hw.has_dcn
    assert hw.mesh_shape == (4,) and hw.mesh_axes == ("x",)
    assert hw.device_name == "" and hw.sm_count == 0
    assert hw.fingerprint == "h100-sxm|mesh=4|axes=x|dcn=0"
    # same mesh, same fingerprint as the reference's context on the V5E
    assert TCTX.fingerprint == JCTX.fingerprint


# ------------------------------------------------------------ no-JAX guard

GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("repro",
                                                          "benchmarks"))
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_no_jax_and_no_repro():
    root = os.path.abspath(ROOT)
    code = GUARD.format(src=os.path.join(root, "src"), root=root)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 25
    # the second slice's modules are among those imported
    assert {"repro_torch.kernels.kv_shuttle", "repro_torch.kernels.ref",
            "repro_torch.workloads.kv_transfer", "repro_torch.configs.registry",
            "repro_torch.models.model", "repro_torch.serve.engine",
            "repro_torch.serve.scheduler"} <= names
    # the seventh slice's: the slow path's copies and the MoE serving path
    assert {"repro_torch.core.slow_path", "repro_torch.core.mutation",
            "repro_torch.core.archive", "repro_torch.core.database",
            "repro_torch.core.meta", "repro_torch.models.moe",
            "repro_torch.dist.sharding", "repro_torch.launch.serve"} <= names
    # the fourteenth slice's: the reference's acceptance suites
    assert {f"repro_torch.suites.{m}" for m in (
        "common", "telemetry", "search_scale", "serving", "verify",
        "workload")} <= names
    # the fifteenth slice's: the paper's tables and figures
    assert {f"repro_torch.figures.{m}" for m in (
        "common", "fig3_flash_attention", "fig4_moe_skew",
        "fig5_kv_transfer", "fig6_gemm_allgather", "table5_moe_phases",
        "fig9_13_ablations", "roofline_cells", "run")} <= names
    # the sixteenth slice's: the train-step timer beside the dry run
    assert {"repro_torch.launch.step_time",
            "repro_torch.launch.dryrun"} <= names
