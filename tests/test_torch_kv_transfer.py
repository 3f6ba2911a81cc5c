"""The port's KV-transfer slice against the JAX package, on the CPU.

The reference's ``kv_shuttle`` kernel fails at trace time on this JAX
version (ROADMAP queue 3), so the port's plain version
(``kv_shuttle_plain``, which the wrapper computes for CPU tensors) is held
against the reference's oracles: ``kernels/ref.py::kv_shuttle_ref`` and
``KVTransfer.reference``. The host builds need two JAX devices, which
these tests do not have, so the port's host and STREAM_SPLIT builds are
held against ``KVTransfer.reference`` too. The search contract (knobs,
schedules, the l0 report, the l3 cost) is compared directive by
directive. Inputs are made with numpy from a seed and handed to both.

Tolerances, max-abs-normalised: 1e-5 for the projections (f32, the same
GEMM in another library); ``pure`` copies and must be exact.
"""
import dataclasses
import itertools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import design_space as jds
from repro.core import verify as jver
from repro.core.hardware import V5E as JV5E
from repro.core.hardware import HardwareContext as JHW
from repro.kernels import ref as jref
from repro.workloads.kv_transfer import KVTransfer as JKV
from repro_torch.core import design_space as tds
from repro_torch.core import verify as tver
from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.comm_graph import analyze
from repro_torch.core.fast_path import fast_path
from repro_torch.core.hardware import H100, V5E, HardwareContext
from repro_torch.core.hardware import extract_hardware_context
from repro_torch.dist import mesh as vmesh
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import kv_shuttle as kern
from repro_torch.kernels import ref as tref
from repro_torch.workloads import get_workload
from repro_torch.workloads.kv_transfer import KVTransfer as TKV
from repro_torch.workloads.kv_transfer import inputs_from_numpy
from torch_port_helpers import rel_err

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CPU = VirtualMesh(2, device="cpu")


def kv_numpy(T, d, dk, seed=0):
    """x (2, T, d) with the prefill rank's rows in x[0], wk/wv (d, dk)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((2, T, d), np.float32)
    x[0] = rng.standard_normal((T, d))
    wk = (rng.standard_normal((d, dk)) / np.sqrt(d)).astype(np.float32)
    wv = (rng.standard_normal((d, dk)) / np.sqrt(d)).astype(np.float32)
    return x, wk, wv


KNOBS = [dict(chained=c, fused=f, counter=k, kv_chunk=kc, contexts=cx)
         for c, f, k, kc, cx in itertools.product(
             (True, False), (True, False), (True, False), (None, 16, 48),
             (1, 2))]


# ------------------------------------------------------------ plain version


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_plain_version_matches_reference_oracles(knobs):
    x, wk, wv = kv_numpy(96, 40, 24, seed=len(str(knobs)))
    jk, jv = JKV(T=96, d=320, dk=96).reference(*map(jnp.asarray, (x, wk, wv)))
    rk, rv = jref.kv_shuttle_ref(*map(jnp.asarray, (x[0], wk, wv)))
    tk, tv = kern.kv_shuttle_plain(*inputs_from_numpy(x, wk, wv,
                                                      device="cpu"), **knobs)
    for got, want, oracle in ((tk, jk, rk), (tv, jv, rv)):
        assert rel_err(got, want) <= 1e-5
        assert rel_err(got[1], oracle) <= 1e-5
        assert not got[0].any()


@pytest.mark.parametrize("knobs", KNOBS[::3], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pure_plain_version_ships_rows_verbatim(knobs, dtype):
    rng = np.random.default_rng(5)
    rows, w = 80, 12
    stacked = rng.standard_normal((2 * rows, w)).astype(np.float32)
    kv = torch.zeros((2, 2 * rows, w), dtype=dtype)
    kv[0] = torch.from_numpy(stacked).to(dtype)
    ko, vo = kern.kv_cache_shuttle(kv, **knobs)
    assert ko.dtype == vo.dtype == dtype and ko.shape == (2, rows, w)
    assert torch.equal(ko[1], kv[0, :rows]) and torch.equal(vo[1], kv[0, rows:])
    assert not ko[0].any() and not vo[0].any()
    # the reference oracle's view of the same handoff: the halves as sent
    half_k, half_v = np.split(kv[0].float().numpy(), 2)
    assert np.array_equal(ko[1].float().numpy(), half_k)
    assert np.array_equal(vo[1].float().numpy(), half_v)


def test_wrapper_checks_its_arguments():
    x = torch.zeros((2, 8, 4))
    w = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="stacked"):
        kern.kv_shuttle(x[:1], w, w)
    with pytest.raises(ValueError, match="contexts"):
        kern.kv_shuttle(x, w, w, contexts=0)
    with pytest.raises(ValueError, match=r"\[K; V\]"):
        kern.kv_cache_shuttle(torch.zeros((2, 7, 4)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kern.kv_shuttle(x.to("meta"), w.to("meta"), w.to("meta"))
    assert kern.launches() == 0           # the plain version counts nothing


def test_variant_names():
    assert kern.variant_name(chained=False, rows=4096) == "sequential"
    assert kern.variant_name(chained=True, rows=4096) == "chained"
    assert kern.variant_name(fused=True, rows=4096) == "fused_signal"
    assert kern.variant_name(fused=True, counter=True, kv_chunk=64,
                             rows=4096) == "fused_counter"
    assert kern.variant_name(fused=True, counter=True, kv_chunk=32,
                             rows=4096) == "fused_counter_kc32"
    assert kern.variant_name(fused=True, counter=True, kv_chunk=1024,
                             pure=True, rows=558080) \
        == "pure_fused_counter_kc1024"
    # a chunk that does not divide the rows is sanitized first
    assert kern.variant_name(fused=True, kv_chunk=100, rows=96) \
        == "fused_signal_kc96"
    for name, knobs in {**kern.VARIANTS, **kern.PURE_VARIANTS}.items():
        pure = name.startswith("pure_")
        assert kern.variant_name(pure=pure, rows=558080 if pure else 4096,
                                 **knobs) == name


# ------------------------------------------------------------------ oracles


def test_port_oracles_equal_reference_oracles():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((3, 40, 16)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=causal)
        got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal)
        assert rel_err(got, want) <= 1e-5
    rq, rk, rv = (rng.standard_normal((4, 2, 24, 8)).astype(np.float32)
                  for _ in range(3))
    want = jref.ring_attention_ref(*map(jnp.asarray, (rq, rk, rv)))
    got = tref.ring_attention_ref(*map(torch.from_numpy, (rq, rk, rv)))
    assert got.shape == want.shape and rel_err(got, want) <= 1e-5
    a = rng.standard_normal((4, 16, 32)).astype(np.float32)
    b = rng.standard_normal((32, 24)).astype(np.float32)
    want = jref.gemm_allgather_ref(jnp.asarray(a), jnp.asarray(b))
    got = tref.gemm_allgather_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape and rel_err(got, want) <= 1e-5
    x, wk, wv = kv_numpy(32, 16, 8)
    for g, w in zip(tref.kv_shuttle_ref(*map(torch.from_numpy,
                                             (x[0], wk, wv))),
                    jref.kv_shuttle_ref(*map(jnp.asarray, (x[0], wk, wv)))):
        assert rel_err(g, w) <= 1e-5


# ----------------------------------------------------------------- builders


@pytest.mark.parametrize("name", ["host", "stream_split", "solo"])
def test_host_builds_match_reference(name):
    x, wk, wv = kv_numpy(64, 32, 16, seed=3)
    jw, tw = JKV(T=64, d=256, dk=64), TKV(T=64, d=256, dk=64)
    if name == "solo":
        jw, tw = jw.degrade((1,)), tw.degrade((1,))
        x = x[:1]
    want = jw.reference(*map(jnp.asarray, (x, wk, wv)))
    ins = inputs_from_numpy(x, wk, wv, device="cpu")
    run = {"host": tw.host_baseline(CPU), "stream_split": tw._stream_split(CPU),
           "solo": tw.build(jds.CONSERVATIVE, VirtualMesh(1, device="cpu"))
           }[name]
    for g, w in zip(run(*ins), want):
        assert g.shape == w.shape and rel_err(g, w) <= 1e-5


def test_mesh_ppermute_and_recorder():
    t = torch.arange(24.0).reshape(3, 2, 4)
    m = VirtualMesh(3, device="cpu")
    with vmesh.record() as events:
        out = m.ppermute(t, [(0, 1), (1, 2)])
    assert torch.equal(out[1], t[0]) and torch.equal(out[2], t[1])
    assert not out[0].any()
    (ev,) = events
    assert ev.kind == "collective-permute" and ev.shape == (2, 4)
    assert ev.payload_bytes == 8 * 4
    with pytest.raises(ValueError, match="permutation"):
        m.ppermute(t, [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="n=3"):
        m.ppermute(t[:2], [(0, 1)])


def test_comm_graph_of_the_host_baseline():
    w = TKV(T=64, d=256, dk=64)
    ins = w.example_inputs(0, CPU)
    g = analyze(w.host_baseline(CPU), *ins)
    (node,) = g.nodes
    assert node.kind == "collective-permute" and node.axes == ("x",)
    assert node.payload_bytes == 64 * 2 * (64 // 4) * 4
    assert "cat" in node.producers and node.consumers
    assert [k for k, _ in g.phases()] == ["compute", "communicate", "compute"]


# -------------------------------------------------------- search contract

JCTX = JHW(chip=JV5E, mesh_shape=(2,), mesh_axes=("x",), chips_per_pod=2,
           n_chips=2, has_dcn=False)
TCTX = HardwareContext(chip=V5E, mesh_shape=(2,), mesh_axes=("x",),
                       chips_per_pod=2, n_chips=2, has_dcn=False)


def _report_view(rep):
    if rep is None:
        return None
    return (rep.ok, rep.subject, rep.checked,
            tuple((e.code, e.rank, e.op_index, e.detail) for e in rep.errors))


def _cost_view(cb):
    sched = None if cb.schedule is None else dataclasses.astuple(cb.schedule)
    return ([(s.name, s.dur_s, s.kind, s.meta) for s in cb.segments],
            cb.knobs, cb.meta, cb.total, sched)


TUNINGS = ((), (("kv_chunk", 32),), (("chained", 1),),
           (("chained", 0), ("kv_chunk", 100)))


@pytest.mark.parametrize("T", [4096, 1000])
def test_search_contract_equal_on_every_directive(T):
    jw, tw = JKV(T=T), TKV(T=T)
    n = 0
    for i, d in enumerate(jds.enumerate_valid(**jw.traits(JCTX))):
        for tun in TUNINGS:
            if tun and i % 4:
                continue
            d2 = dataclasses.replace(d, tunables=tun)
            td = tds.directive_from_dict(d2.as_dict())
            assert tw.check(td, TCTX) == jw.check(d2, JCTX)
            assert tw.kernel_knobs(td) == jw.kernel_knobs(d2), d2
            js, ts = jw.collective_schedule(d2), tw.collective_schedule(td)
            assert (ts is None) == (js is None)
            if ts is not None:
                assert dataclasses.astuple(ts) == dataclasses.astuple(js)
            assert _cost_view(tw.cost_breakdown(td, TCTX)) \
                == _cost_view(jw.cost_breakdown(d2, JCTX)), d2
            assert tw.analytic_cost(td, TCTX) == jw.analytic_cost(d2, JCTX)
            if d.backend == "PALLAS_RDMA" and i % 8 == 0 and T < 4096:
                assert _report_view(tver.verify_directive(tw, td)) \
                    == _report_view(jver.verify_directive(jw, d2)), d2
            n += 1
    assert n > 500


@pytest.mark.parametrize("name", list(jds.EXPERT_SYSTEMS) + ["chained",
                                                             "fused SIGNAL"])
def test_l0_reports_equal_for_the_main_path_directives(name):
    d = chip_smoke.kv_directives()[name]
    jd = jds.Directive(**{k: v for k, v in d.as_dict().items()
                          if k != "tunables"})
    jw, tw = JKV(), TKV()
    assert tw.check(d, TCTX) == [] and jw.check(jd, JCTX) == []
    assert _report_view(tver.verify_directive(tw, d)) \
        == _report_view(jver.verify_directive(jw, jd))


def test_degrade_and_solo_equal():
    jw, tw = JKV(T=512, d=256, dk=64), TKV(T=512, d=256, dk=64)
    assert tw.degrade((0, 1)) is tw
    for live in ((0,), (1,)):
        jd, td = jw.degrade(live), tw.degrade(live)
        assert td.solo and td.n_dev == jd.n_dev == 1
        assert td.fingerprint() == jd.fingerprint()
        assert td.state_bytes_per_rank() == jd.state_bytes_per_rank()
        for d in (jds.CONSERVATIVE, jds.EXPERT_SYSTEMS["FLUX"]):
            td_ = tds.directive_from_dict(d.as_dict())
            assert _cost_view(td.cost_breakdown(td_, TCTX)) \
                == _cost_view(jd.cost_breakdown(d, JCTX))
            assert td.collective_schedule(td_) is None
    assert tw.fingerprint() == jw.fingerprint()
    assert get_workload("kv_transfer").fingerprint() == JKV().fingerprint()


# ------------------------------------------------------------ cascade / fast


def test_fast_path_reaches_level_three_on_a_small_shuttle():
    w = TKV(T=256, d=128, dk=64)
    hw = extract_hardware_context(CPU, H100)
    seed = fast_path(w, CPU, hw)
    assert seed.directive.backend == "PALLAS_RDMA"
    assert seed.candidate.result.level == 3
    assert seed.graph.nodes[0].kind == "collective-permute"
    ev = CascadeEvaluator(w, CPU, hw)
    for name, d in chip_smoke.kv_directives().items():
        r = ev.evaluate(Candidate(d, mutation=name))
        assert r.level == 3, (name, r.diagnostic)


def test_cascade_rejects_a_wrong_shuttle():
    w = TKV(T=128, d=64, dk=32)
    hw = extract_hardware_context(CPU, H100)
    ev = CascadeEvaluator(w, CPU, hw)
    good = w.build
    w.build = lambda d, mesh: (lambda x, wk, wv: good(d, mesh)(x, wv, wk))
    r = ev.evaluate(Candidate(jds.EXPERT_SYSTEMS["FLUX"]))
    assert r.level == 1 and r.rejection == "l2:mismatch"


# ------------------------------------------------------------- chip_smoke


def test_chip_smoke_kv_phases_on_the_cpu():
    """The smoke's kv phases at a tiny size on the CPU, where the wrapper
    computes the plain version (every error 0, no launch counted)."""
    recs = chip_smoke.phase_kv_kernels(
        "cpu", chip_smoke.kv_workload(small=True),
        chip_smoke.engine_config(small=True), chip_smoke.serve_shape(small=True),
        iters=1)
    assert len(recs) == len(kern.VARIANTS) + len(kern.PURE_VARIANTS)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for rec in recs:
        assert keys <= set(rec) and rec["max_abs_err"] == 0.0
        assert rec["_path"] in ("kv_main", "serve")
        assert os.path.exists(os.path.join(ROOT, rec["source"]))
        assert rec["replaces"].startswith("src/repro/kernels/kv_shuttle.py:")
    assert chip_smoke.phase_kv_main("cpu",
                                    chip_smoke.kv_workload(small=True)) == {}


def test_chip_smoke_kv_bound_from_the_shapes():
    ms, by, flops, nbytes = chip_smoke.kv_bound(pure=False, rows=4096,
                                                width=512, d=4096)
    assert flops == 2 * 2 * 4096 * 4096 * 512
    # the projections run as 3xTF32: three TF32 products per multiply-add
    rate = 495e12 / 3
    assert by == "operations" and abs(ms - flops / rate * 1e3) < 1e-12
    cfg = chip_smoke.engine_config()
    rows = chip_smoke.cache_rows(cfg, 8, 512 + 32 + 1)
    assert rows == 558080
    ms, by, flops, nbytes = chip_smoke.kv_bound(pure=True, rows=rows,
                                                width=64, esize=2)
    assert flops == 0 and by == "bytes"
    assert nbytes == 3 * 2 * rows * 64 * 2
    assert abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
