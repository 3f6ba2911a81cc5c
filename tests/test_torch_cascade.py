"""The port's cascade, fast path and chip smoke phases on the CPU.

Held against the reference where the reference runs here: the JAX cascade
reaches level 3 for the XLA directives at n=1, so their EvalRecords'
deterministic fields must be equal. Kernel directives stop at ``l1:build``
in the reference on this JAX version (its Pallas kernel does not trace),
so for them the port's l0 report and l3 model are compared with the
reference's ``verify_directive`` and ``cost_breakdown`` directly, and l2
is the port's plain version against the oracle.
"""
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import jax.numpy as jnp
from repro.compat import make_mesh
from repro.core import cascade as jcas
from repro.core import design_space as jds
from repro.core import verify as jver
from repro.core.hardware import V5E as JV5E
from repro.core.hardware import HardwareContext as JHW
from repro.workloads.moe_dispatch import MoEDispatch as JMoE
from repro.workloads.serving import ServingStep as JServing
from repro_torch.core import design_space as tds
from repro_torch.core import verify as tver
from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.fast_path import DEVICE_CONSERVATIVE, fast_path
from repro_torch.core.hardware import V5E, HardwareContext
from repro_torch.core.telemetry import EvalRecord, MetricsRegistry, wallclock_us
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import moe_dispatch as kern
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.moe_dispatch import inputs_from_numpy
from repro_torch.workloads.serving import ServingStep as TServing
from torch_port_helpers import numpy_inputs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def ctx(chip_cls, spec, n):
    return chip_cls(chip=spec, mesh_shape=(n,), mesh_axes=("x",),
                    chips_per_pod=n, n_chips=n, has_dcn=False)


def pair(serving, n, T=64, d=64, f=64):
    if serving:
        return (JServing(n_dev=n, tokens_per_rank=T, d=d, f=f, f_shared=f),
                TServing(n_dev=n, tokens_per_rank=T, d=d, f=f, f_shared=f))
    return (JMoE(n_dev=n, tokens_per_rank=T, d=d, f=f),
            TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f))


def evaluators(serving, n, **kw):
    jw, tw = pair(serving, n)
    arrs = numpy_inputs(n, 64, 64, 64, 64 if serving else 0, seed=n)
    jev = jcas.CascadeEvaluator(
        jw, make_mesh((1,), ("x",)), ctx(JHW, JV5E, n),
        verify_inputs=tuple(jnp.asarray(a) for a in arrs), **kw)
    tev = CascadeEvaluator(tw, VirtualMesh(n, device="cpu"),
                           ctx(HardwareContext, V5E, n),
                           verify_inputs=inputs_from_numpy(*arrs,
                                                           device="cpu"),
                           **kw)
    return jev, tev


XLA_POINTS = [jds.CONSERVATIVE, jds.EXPERT_SYSTEMS["TokenWeave"],
              jds.CONSERVATIVE.with_tunable("wire_i8", 1),
              jds.Directive("XLA_COLLECTIVE", "SIGNAL", "DEFERRED")]


@pytest.mark.parametrize("serving", [False, True])
def test_eval_records_equal_reference_for_xla_points_at_one_rank(serving):
    jev, tev = evaluators(serving, 1)
    for i, d in enumerate(XLA_POINTS):
        jr = jev.evaluate(jcas.Candidate(d, cid=i, mutation="m"))
        tr = tev.evaluate(Candidate(tds.directive_from_dict(d.as_dict()),
                                    cid=i, mutation="m"))
        want = jr.record.deterministic_dict()
        got = tr.record.deterministic_dict()
        assert got.pop("device") == "cpu"
        assert got == want, d
        assert (tr.level, tr.rejection) == (jr.level, jr.rejection)
    assert tev.records[-1].rejection == "invalid"


@pytest.mark.parametrize("serving", [False, True])
def test_kernel_points_l0_and_l3_equal_reference_and_l2_holds(serving):
    jw, tw = pair(serving, 4, T=256)
    arrs = numpy_inputs(4, 256, 64, 64, 64 if serving else 0, seed=3)
    tev = CascadeEvaluator(tw, VirtualMesh(4, device="cpu"),
                           ctx(HardwareContext, V5E, 4),
                           verify_inputs=inputs_from_numpy(*arrs,
                                                           device="cpu"))
    points = list(jds.EXPERT_SYSTEMS.values()) + [
        jds.Directive("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", "LOCAL",
                      "GRID_STEP", "PER_PEER", "ACQUIRE", 2),
        jds.EXPERT_SYSTEMS["FLUX"].with_tunable("wire_i8", 1),
        jds.EXPERT_SYSTEMS["FLUX"].with_tunable("combine_tile", 16)]
    for d in points:
        td = tds.directive_from_dict(d.as_dict())
        jrep, trep = jver.verify_directive(jw, d), tver.verify_directive(tw, td)
        assert (trep is None) == (jrep is None)
        if jrep is not None:
            assert (trep.ok, trep.subject, trep.checked) \
                == (jrep.ok, jrep.subject, jrep.checked)
        r = tev.evaluate(Candidate(td))
        assert r.level == 3, r.diagnostic
        want_ms = jw.cost_breakdown(d, ctx(JHW, JV5E, 4)).total * 1e3
        assert r.t_model_ms == want_ms
        assert r.score == 10000.0 / (1.0 + want_ms)


def test_l2_rejects_wrong_numbers_and_retries_flaky_runs():
    _, tev = evaluators(False, 4)
    calls = []

    def wrong(fn):
        return fn(*tev.inputs) * 1.01

    tev._run_l2 = wrong
    r = tev.evaluate(Candidate(DEVICE_CONSERVATIVE))
    assert (r.level, r.rejection) == (1, "l2:mismatch")

    def flaky(fn):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return fn(*tev.inputs)

    tev._run_l2 = flaky
    tev.backoff_s = 0.0
    r = tev.evaluate(Candidate(DEVICE_CONSERVATIVE))
    assert (r.level, r.retries) == (3, 1)

    def nonfinite(fn):
        return fn(*tev.inputs) * float("nan")

    tev._run_l2 = nonfinite
    r = tev.evaluate(Candidate(DEVICE_CONSERVATIVE))
    assert r.rejection == "l2:nonfinite"


def test_timeout_quarantines_a_wedged_candidate():
    _, tev = evaluators(False, 4, timeout_s=0.3)

    def wedge(fn):
        time.sleep(2.0)
        return fn(*tev.inputs)

    tev._run_l2 = wedge
    r = tev.evaluate(Candidate(DEVICE_CONSERVATIVE, cid=7))
    assert r.quarantined and r.rejection == "quarantine"
    assert tev.quarantine_report()[0]["cid"] == 7


def test_evaluate_batch_equals_sequential():
    cands = lambda: [Candidate(tds.directive_from_dict(d.as_dict()), cid=i)  # noqa: E731
                     for i, d in enumerate(list(jds.EXPERT_SYSTEMS.values())
                                           + XLA_POINTS)]
    _, seq = evaluators(True, 4)
    _, bat = evaluators(True, 4, batch_workers=3)
    want = [seq.evaluate(c) for c in cands()]
    got = bat.evaluate_batch(cands())
    assert [r.record.deterministic_dict() for r in got] \
        == [r.record.deterministic_dict() for r in want]
    assert [r.deterministic_dict() for r in bat.records] \
        == [r.deterministic_dict() for r in seq.records]


@pytest.mark.parametrize("serving", [False, True])
def test_fast_path_seeds_the_kernel_directive(serving):
    _, tw = pair(serving, 4, T=256)
    mesh = VirtualMesh(4, device="cpu")
    seed = fast_path(tw, mesh, ctx(HardwareContext, V5E, 4))
    assert seed.directive.backend == "PALLAS_RDMA"
    assert seed.candidate.result.level == 3
    assert [n.kind for n in seed.graph.nodes] == ["all-to-all"] * 2
    assert seed.evolve_dims == tw.evolve_dims
    assert "stage B verified" in seed.log[-1]


def test_full_f32_is_scoped_to_the_card_and_restored():
    """The cascade turns TF32 off only around its own matmuls on a card,
    and leaves the process's setting as it found it."""
    from repro_torch.core.cascade import _full_f32
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with _full_f32(torch.device("cuda")):
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with _full_f32(torch.device("cpu")):
            assert torch.backends.cuda.matmul.allow_tf32
        evaluators(False, 1)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_telemetry_round_trip_and_wallclock():
    rec = EvalRecord(cid=1, level=3, score=2.0, t_model_ms=float("inf"),
                     device="cpu", levels_s={"l0": 0.1})
    back = EvalRecord.from_json(rec.to_json())
    assert back.t_model_ms is None and back.device == "cpu"
    assert "device" in back.deterministic_dict()
    reg = MetricsRegistry()
    reg.counter("launches").inc()
    reg.histogram("ms").observe(2.0)
    assert reg.snapshot()["counters"]["launches"] == 1.0
    us = wallclock_us(lambda a: a + 1, (torch.zeros(4),), iters=2)
    assert us > 0


# ------------------------------------------------------------- chip_smoke


def test_chip_smoke_phases_on_the_cpu():
    """The smoke's phases run end to end at a tiny size on the CPU (where
    the wrapper computes the plain version, so every error is 0)."""
    assert chip_smoke.phase_device("cpu")["platform"] == "cpu"
    chip_smoke.phase_build("cpu")
    small = chip_smoke.main_path_workloads(small=True)
    recs = chip_smoke.phase_kernels("cpu", small, iters=1)
    assert len(recs) == 2 * len(kern.VARIANTS)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    nv = len(kern.VARIANTS)
    for i, rec in enumerate(recs):
        assert keys <= set(rec) and rec["max_abs_err"] == 0.0
        # each record's bound is its workload's (at this tiny size the
        # 3xTF32 rate leaves some bound by bytes)
        w = small[i // nv]
        ms, by, _ = chip_smoke.bound(w, [int(c) for c in w._counts(w.T)])
        assert (rec["bound_ms"], rec["bound_by"]) == (ms, by)
        assert os.path.exists(os.path.join(ROOT, rec["source"]))
    counts = chip_smoke.phase_main("cpu", small)
    assert counts == {}                          # no kernel on the CPU


def test_chip_smoke_gemm_core_on_the_cpu():
    """The smoke's gemm_core line at test size on the CPU, where the
    wrappers compute the plain version; the full shapes are the serving
    cell's expert GEMMs, kv_transfer's projection, the KV cell's, which
    also times kv_shuttle.cu's wgmma core alone, the LongCat cell's
    router and FFN2, prefill_skew's busiest expert at skew 5 and a packed
    64-row unit of the LongCat cell."""
    recs = chip_smoke.phase_gemm_core(
        "cpu", chip_smoke.gemm_core_shapes(small=True), iters=1)
    assert [r["name"] for r in recs] == [
        "moe_gemm1_swiglu", "moe_gemm2", "skewed_gemm1_swiglu",
        "skewed_gemm2", "kv_projection", chip_smoke.KV_CORE,
        "scmoe_router", "scmoe_ffn2_gemm1_swiglu", "scmoe_ffn2_gemm2",
        "prefill_skew5_gemm1_swiglu", "prefill_skew5_gemm2",
        "scmoe_packed_gemm1_swiglu", "scmoe_packed_gemm2"]
    for rec in recs:
        assert rec["ms"] > 0 and rec["matmul_ms"] > 0 and rec["bound_ms"] > 0
    assert recs[5]["wgmma_ms"] > 0
    shapes = chip_smoke.gemm_core_shapes()
    assert [s[1:] for s in shapes] == [(256, 7168, 4096, True),
                                       (256, 2048, 7168, False),
                                       (768, 512, 2048, True),
                                       (768, 1024, 512, False),
                                       (4096, 4096, 512, False),
                                       (8192, 4096, 2048, False),
                                       (1024, 6144, 768, False),
                                       (1024, 6144, 24576, True),
                                       (1024, 12288, 6144, False),
                                       (13312, 7168, 4096, True),
                                       (13312, 2048, 7168, False),
                                       (64, 6144, 4096, True),
                                       (64, 2048, 6144, False)]


def test_chip_smoke_scmoe_phase_on_the_cpu():
    """The smoke's ScMoE phase at the CPU tests' size: the cell's build
    held to LongCat's reference, then the kernel's record on the layer's
    own table of rows per pair (every pair's rows, not one row per
    expert), its launches taken from the counted ``scmoe`` path under the
    key the wrapper counts (x holds T k rows a rank)."""
    w = chip_smoke.scmoe_workload(small=True)
    counts, recs = chip_smoke.phase_scmoe("cpu", w, iters=1)
    assert counts == {}                          # no kernel on the CPU
    (rec,) = recs
    assert rec["name"] == "moe_dispatch/tile_fused+shared@scmoe_step"
    assert rec["max_abs_err"] == 0.0 and rec["_path"] == "scmoe"
    assert rec["_key"] == ("tile_fused+shared", 8, w.T * w.topk, w.d, w.f)
    full = chip_smoke.scmoe_workload()
    assert (full.n_dev, full.T, full.d, full.f, full.f_dense, full.n_experts,
            full.n_zero, full.topk) == (8, 128, 6144, 2048, 12288, 512, 256,
                                        12)
    # the bound of a table: its routed rows and the second stream's T rows
    pairs = [[1, 2], [3, 0]]
    ms, by, flops, nbytes = chip_smoke.scmoe_bound(pairs, 4, 64, 32, 128)
    assert flops == 6 * 6 * 64 * 32 + 6 * 2 * 4 * 64 * 128
    assert (ms, by, flops, nbytes) == chip_smoke.moe_bound(
        2, [2.0, 1.0], 64, 32, 128, 4, xs_is_x=False)


def test_chip_smoke_bound_counts_routed_tokens():
    ms, by, flops = chip_smoke.bound(TServing(n_dev=4), [64, 64, 64, 64])
    assert flops == 2 * 6 * 4 * 256 * 7168 * 2048
    # the kernel's GEMMs run as 3xTF32: three TF32 products per multiply-add
    rate = 495e12 / 3
    assert by == "operations" and abs(ms - flops / rate * 1e3) < 1e-12


def test_chip_smoke_moe_model_records_on_the_cpu():
    """The ``kernels`` line's moe records at the MoE engine's prefill and
    decode shapes: the knobs ``_pallas_body`` launches, every key of the
    line, launches taken from ``serve_moe`` under the key the wrapper
    counts; at full size the prefill is bound by operations and the
    decode by the bytes of its f32 weights."""
    cfg = chip_smoke.moe_engine_config(small=True)
    shape = chip_smoke.moe_serve_shape(small=True)
    recs = chip_smoke.phase_moe_model_kernels("cpu", cfg, shape, iters=1)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    d, f = cfg.d_model, cfg.moe_d_ff
    assert [r["name"] for r in recs] == [
        "moe_dispatch/tile_fused+shared@llama4_prefill",
        "moe_dispatch/tile_fused+shared@llama4_decode"]
    for rec, (_, T, C) in zip(recs, chip_smoke.moe_call_shapes(cfg, shape)):
        assert keys <= set(rec) and rec["max_abs_err"] == 0.0
        assert rec["_path"] == "serve_moe"
        assert rec["_key"] == ("tile_fused+shared", 4, 4 * C, d, f)
        ms, by, _, _ = chip_smoke.moe_bound(4, [C] * 4, d, f, f, T,
                                            xs_is_x=False)
        assert (rec["bound_ms"], rec["bound_by"]) == (ms, by)
    full = chip_smoke.moe_engine_config()
    (_, Tp, Cp), (_, Td, Cd) = chip_smoke.moe_call_shapes(full, (8, 512, 32))
    ms, by, flops, _ = chip_smoke.moe_bound(4, [Cp] * 4, 5120, 8192, 8192,
                                            Tp, xs_is_x=False)
    assert by == "operations" and flops == 6 * 4 * 5120 * 8192 * (
        4 * Cp + Tp)
    ms, by, _, nbytes = chip_smoke.moe_bound(4, [Cd] * 4, 5120, 8192, 8192,
                                             Td, xs_is_x=False)
    weights = 4 * (4 * 3 * 5120 * 8192 + 3 * 5120 * 8192)
    assert by == "bytes" and weights < nbytes < weights * 1.001
    assert abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
