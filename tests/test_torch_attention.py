"""The port's attention slice (flash attention, ring attention, the ops
wrappers) against the JAX package, on the CPU.

The reference's Pallas ``flash_attention`` runs in interpret mode, and its
``ring_attention`` does at one rank (no DMA semaphore is waited on), so
the port's plain versions (which the wrappers compute for CPU tensors) are
held against the executed kernels there. At more ranks the ring's Pallas
variants fail at trace time on this JAX version (ROADMAP queue 3), and the
plain version is held against ``kernels/ref.py::ring_attention_ref`` and
``RingAttention.reference``. The host and STREAM_SPLIT builds are held
against the reference's XLA builds at four host devices, which run in a
subprocess. The search contract (knobs, schedules, the l0 report, the l3
cost) is compared directive by directive. Inputs are made with numpy from
a seed and handed to both.

Tolerances, max-abs-normalised: 1e-5 in f32 (the same softmax in another
library, sums in another order); 1e-2 for bf16 flash attention (both
round their output to bf16, one bf16 ulp being 2^-8 of a value). The bf16
ring is held per element: within one bf16 step (2^-7 of the value) plus
1e-4, as both sides round an f32 result.
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
from repro.launch.mesh import make_mesh
from repro.workloads.ring_attention import RingAttention as JRing
from repro_torch.core import design_space as tds
from repro_torch.core import verify as tver
from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.fast_path import fast_path
from repro_torch.core.hardware import H100, V5E, HardwareContext
from repro_torch.core.hardware import extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_allgather as ga
from repro_torch.kernels import kv_shuttle as kv
from repro_torch.kernels import ops
from repro_torch.kernels import ring_attention as ra
from repro_torch.workloads import get_workload
from repro_torch.workloads.ring_attention import RingAttention as TRing
from repro_torch.workloads.ring_attention import inputs_from_numpy
from torch_port_helpers import rel_err, run_jax_devices

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CPU = VirtualMesh(4, device="cpu")


def qkv_numpy(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(3)]


# ------------------------------------------------------------------ flash


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128),
                                    (128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_executed_pallas(causal, blocks, dtype):
    from repro.kernels.flash_attention import flash_attention as jfa
    q, k, v = qkv_numpy((2, 256, 32), seed=sum(blocks))
    qb, kb = blocks
    jdt = getattr(jnp, dtype)
    want = jfa(*(jnp.asarray(t, jdt) for t in (q, k, v)), causal=causal,
               q_block=qb, kv_block=kb, interpret=True)
    tdt = getattr(torch, dtype)
    got = fa.flash_attention(*(torch.from_numpy(t).to(tdt)
                               for t in (q, k, v)),
                             causal=causal, q_block=qb, kv_block=kb)
    assert got.dtype == tdt and got.shape == want.shape
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_the_oracle_with_more_keys(causal):
    q = qkv_numpy((3, 64, 16), seed=4)[0]
    _, k, v = qkv_numpy((3, 192, 16), seed=5)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, q_block=32, kv_block=64)
    assert rel_err(got, want) <= 1e-5


def test_flash_large_logits_stay_finite():
    q = qkv_numpy((1, 128, 64), seed=7, scale=30.0)[0]
    got = fa.flash_attention(*(torch.from_numpy(q),) * 3)
    want = jref.flash_attention_ref(*(jnp.asarray(q),) * 3)
    assert bool(torch.isfinite(got).all()) and rel_err(got, want) <= 1e-5


def test_flash_checks_its_arguments():
    q = torch.zeros((1, 100, 64))
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match=r"\(BH, S, hd\)"):
        fa.flash_attention(q, q[:, :, :32], q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*(torch.zeros((1, 64, 8), device="meta"),) * 3,
                           q_block=64, kv_block=64)
    assert fa.launches() == 0             # the plain version counts nothing


# ------------------------------------------------------------------- ring

REALIZATIONS = {
    "deferred": dict(pipelined=False),
    "eager": dict(pipelined=True, eager_wait=True),
    "pipelined": dict(pipelined=True),
    "fused_signal": dict(fused=True, counter=False, kv_chunk=16),
    "fused_counter": dict(fused=True, counter=True, kv_chunk=16),
}


@pytest.mark.parametrize("name", list(REALIZATIONS))
def test_ring_plain_matches_executed_pallas_at_one_rank(name):
    from repro.kernels.ring_attention import ring_attention as jring
    q, k, v = qkv_numpy((1, 2, 64, 16), seed=len(name))
    knobs = REALIZATIONS[name]
    want = jring(*map(jnp.asarray, (q, k, v)), make_mesh((1,), ("x",)),
                 **knobs)
    got = ra.ring_attention(*inputs_from_numpy(q, k, v, device="cpu"),
                            **knobs)
    assert got.shape == want.shape and rel_err(got, want) <= 1e-5


KNOBS = [dict(fused=f, counter=c, pipelined=p, eager_wait=e, kv_chunk=kc,
              contexts=cx)
         for f, c, p, e, kc, cx in itertools.product(
             (True, False), (True, False), (True, False), (True, False),
             (None, 16, 40, 100), (1, 2))
         if not (f and (not p or e))]      # fused ignores the fence knobs


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_ring_plain_matches_reference_oracles(n, knobs):
    """Every knob set, including chunk rows the schedule must sanitize
    (40 and 100 do not divide 48 rows)."""
    q, k, v = qkv_numpy((n, 2, 48, 8), seed=n + len(str(knobs)))
    want = jref.ring_attention_ref(*map(jnp.asarray, (q, k, v)))
    also = JRing(n_dev=n, BH=2, seq=48 * n, hd=8).reference(
        *map(jnp.asarray, (q, k, v)))
    ins = inputs_from_numpy(q, k, v, device="cpu")
    got = ra.ring_attention(*ins, VirtualMesh(n, device="cpu"), **knobs)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5 and rel_err(got, also) <= 1e-5


BF16_STEP = 2.0 ** -7      # one bf16 step is at most 2^-7 of the value


def bf16_steps(got, want):
    """Largest |got - want| / (2^-7 |want| + 1e-4): at most 1 when every
    element is within one bf16 step of the other side (plus 1e-4). Both
    sides round an f32 result to bf16, so a right port is at most one
    rounding step off."""
    got = torch.as_tensor(np.asarray(got, np.float32)) \
        if not isinstance(got, torch.Tensor) else got.float()
    want = torch.as_tensor(np.asarray(want, np.float32))
    assert bool(torch.isfinite(got).all())
    return float(((got - want).abs()
                  / (BF16_STEP * want.abs() + 1e-4)).max())


@pytest.mark.parametrize("name", list(REALIZATIONS))
def test_bf16_ring_plain_matches_executed_pallas_at_one_rank(name):
    """The reference ring runs in q's dtype (bf16 buffers and output, f32
    math), and so does the port's: bf16 in, bf16 out, each element within
    one bf16 step of the executed Pallas kernel's plus 1e-4."""
    from repro.kernels.ring_attention import ring_attention as jring
    q, k, v = qkv_numpy((1, 2, 64, 16), seed=10 + len(name))
    knobs = REALIZATIONS[name]
    want = jring(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                 make_mesh((1,), ("x",)), **knobs)
    got = ra.ring_attention(*(torch.from_numpy(t).bfloat16()
                              for t in (q, k, v)), **knobs)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape and bf16_steps(got, want) <= 1.0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["pipelined", "fused_counter"])
def test_bf16_ring_plain_matches_the_reference_oracle(n, name):
    """At n = 2 and 4 against ``ring_attention_ref`` on the same bf16
    inputs (the oracle also rounds an f32 result to bf16)."""
    q, k, v = qkv_numpy((n, 2, 48, 8), seed=20 + n)
    want = jref.ring_attention_ref(*(jnp.asarray(t, jnp.bfloat16)
                                     for t in (q, k, v)))
    got = ra.ring_attention(*(torch.from_numpy(t).bfloat16()
                              for t in (q, k, v)),
                            VirtualMesh(n, device="cpu"), **REALIZATIONS[name])
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape and bf16_steps(got, want) <= 1.0


@pytest.mark.parametrize("n", [1, 3])
def test_ring_plain_without_the_mask(n):
    q, k, v = qkv_numpy((n, 2, 32, 8), seed=n)
    want = jref.ring_attention_ref(*map(jnp.asarray, (q, k, v)),
                                   causal=False)
    got = ra.ring_attention(*inputs_from_numpy(q, k, v, device="cpu"),
                            causal=False, fused=True, kv_chunk=8)
    assert rel_err(got, want) <= 1e-5


def test_ring_variant_names_and_schedules():
    assert ra.variant_name(pipelined=False, n=4, Sl=1024) == "deferred"
    assert ra.variant_name(eager_wait=True, n=4, Sl=1024) == "eager"
    assert ra.variant_name(n=4, Sl=1024) == "pipelined"
    assert ra.variant_name(fused=True, n=4, Sl=1024) == "fused_signal"
    assert ra.variant_name(fused=True, counter=True, kv_chunk=16, n=4,
                           Sl=1024) == "fused_counter_kc16"
    assert ra.variant_name(fused=True, kv_chunk=100, n=4, Sl=96) \
        == "fused_signal_kc96"
    assert ra.variant_name(causal=False, n=4, Sl=64) == "pipelined_full"
    for name, knobs in ra.VARIANTS.items():
        assert ra.variant_name(n=4, Sl=1024, **knobs) == name
    for name, knobs in ra.BF16_VARIANTS.items():
        assert ra.variant_name(n=4, Sl=1024, dtype=torch.bfloat16,
                               **knobs) == name
    # the reference's entry builds the same schedule
    assert ra.schedule_for(4, 96, fused=True).kv_chunk == 48
    assert ra.schedule_for(4, 96).kv_chunk == 96
    assert ra.schedule_for(4, 96, fused=True, kv_chunk=40).kv_chunk == 32


def test_ring_checks_its_arguments():
    q = torch.zeros((4, 2, 16, 8))
    with pytest.raises(ValueError, match="alike"):
        ra.ring_attention(q, q[:, :1], q)
    with pytest.raises(ValueError, match="contexts"):
        ra.ring_attention(q, q, q, contexts=0)
    with pytest.raises(ValueError, match="mesh of 2"):
        ra.ring_attention(q, q, q, VirtualMesh(2, device="cpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ra.ring_attention(*(q.to("meta"),) * 3)
    assert ra.launches() == 0


# ------------------------------------------------------------------- ops


def test_ops_wrappers_match_the_reference_ops():
    """The port's public wrappers take the reference's arguments and give
    its answers (its jit wrappers run in interpret mode at one rank)."""
    from repro.kernels import ops as jops
    mesh1 = make_mesh((1,), ("x",))
    q, k, v = qkv_numpy((2, 128, 16), seed=1)
    assert rel_err(ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       q_block=64, kv_block=64),
                   jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                        q_block=64, kv_block=64)) <= 1e-5
    rq, rk, rv = qkv_numpy((1, 2, 32, 8), seed=2)
    assert rel_err(ops.ring_attention(*map(torch.from_numpy, (rq, rk, rv)),
                                      VirtualMesh(1, device="cpu"),
                                      fused=True, counter=True, kv_chunk=8),
                   jops.ring_attention(*map(jnp.asarray, (rq, rk, rv)),
                                       mesh1, fused=True, counter=True,
                                       kv_chunk=8)) <= 1e-5
    rng = np.random.default_rng(3)
    a = rng.standard_normal((1, 32, 16)).astype(np.float32)
    b = rng.standard_normal((16, 24)).astype(np.float32)
    assert rel_err(ops.gemm_allgather(torch.from_numpy(a),
                                      torch.from_numpy(b),
                                      VirtualMesh(1, device="cpu"),
                                      tile_m=16),
                   jops.gemm_allgather(jnp.asarray(a), jnp.asarray(b), mesh1,
                                       tile_m=16)) <= 1e-5
    x = np.zeros((2, 32, 16), np.float32)
    x[0] = rng.standard_normal((32, 16))
    wk, wv = (rng.standard_normal((16, 8)).astype(np.float32)
              for _ in range(2))
    kk, vv = ops.kv_shuttle(*map(torch.from_numpy, (x, wk, wv)),
                            VirtualMesh(2, device="cpu"), fused=True)
    rk, rv = jref.kv_shuttle_ref(*map(jnp.asarray, (x[0], wk, wv)))
    assert rel_err(kk[1], rk) <= 1e-5 and rel_err(vv[1], rv) <= 1e-5
    with pytest.raises(ValueError, match="mesh of 4"):
        ops.kv_shuttle(*map(torch.from_numpy, (x, wk, wv)), CPU)
    assert fa.launches() == ra.launches() == ga.launches() \
        == kv.launches() == 0


# ----------------------------------------------------------------- builders

HOST_BUILDS = """
import sys
import jax.numpy as jnp
import numpy as np
from repro.launch.mesh import make_mesh
from repro.workloads.ring_attention import RingAttention
d = np.load(sys.argv[1])
q, k, v = (jnp.asarray(d[x]) for x in "qkv")
n, BH, sl, hd = q.shape
w = RingAttention(n_dev=n, BH=BH, seq=n * sl, hd=hd)
mesh = make_mesh((n,), ("x",))
out = {"host": w.host_baseline(mesh)(q, k, v),
       "stream_split": w._stream_split(mesh)(q, k, v),
       "reference": w.reference(q, k, v)}
np.savez(sys.argv[2], **{x: np.asarray(y) for x, y in out.items()})
"""


@pytest.fixture(scope="module")
def jax_host_builds(tmp_path_factory):
    q, k, v = qkv_numpy((4, 2, 32, 16), seed=6)
    got = run_jax_devices(HOST_BUILDS, {"q": q, "k": k, "v": v},
                          str(tmp_path_factory.mktemp("ring_host")))
    return (q, k, v), got


@pytest.mark.parametrize("name", ["host", "stream_split"])
def test_host_builds_match_the_reference_builds_at_four_ranks(
        jax_host_builds, name):
    (q, k, v), want = jax_host_builds
    w = TRing(n_dev=4, BH=2, seq=128, hd=16)
    run = w.host_baseline(CPU) if name == "host" else w._stream_split(CPU)
    got = run(*inputs_from_numpy(q, k, v, device="cpu"))
    assert got.shape == want[name].shape == (4, 2, 32, 16)
    assert rel_err(got, want[name]) <= 1e-5
    assert rel_err(got, want["reference"]) <= 1e-5


def test_host_baseline_rotates_after_compute():
    """The host build's comm graph: 2n permutes, each round's after its
    compute; STREAM_SPLIT issues the round's two permutes first."""
    from repro_torch.core.comm_graph import analyze
    w = TRing(n_dev=4, BH=2, seq=128, hd=16)
    ins = w.example_inputs(0, CPU)
    host = analyze(w.host_baseline(CPU), *ins)
    split = analyze(w._stream_split(CPU), *ins)
    for g in (host, split):
        assert [nd.kind for nd in g.nodes] == ["collective-permute"] * 8
        assert g.collective_bytes == 8 * 2 * 32 * 16 * 4
    assert host.phases()[0][0] == "compute"
    assert [k for k, _ in split.phases()[:2]] == ["compute", "communicate"]
    assert split.phases()[1:3] == [("communicate", "collective_permute")] * 2


# -------------------------------------------------------- search contract

JCTX = JHW(chip=JV5E, mesh_shape=(4,), mesh_axes=("x",), chips_per_pod=4,
           n_chips=4, has_dcn=False)
TCTX = HardwareContext(chip=V5E, mesh_shape=(4,), mesh_axes=("x",),
                       chips_per_pod=4, n_chips=4, has_dcn=False)


def _report_view(rep):
    if rep is None:
        return None
    return (rep.ok, rep.subject, rep.checked,
            tuple((e.code, e.rank, e.op_index, e.detail) for e in rep.errors))


def _cost_view(cb):
    sched = None if cb.schedule is None else dataclasses.astuple(cb.schedule)
    return ([(s.name, s.dur_s, s.kind, s.meta) for s in cb.segments],
            cb.knobs, cb.meta, cb.total, sched)


TUNINGS = ((), (("kv_chunk", 16),), (("kv_chunk", 100),),
           (("kv_chunk", 256),))


@pytest.mark.parametrize("shape", [dict(), dict(BH=96, seq=8192),
                                   dict(BH=2, seq=512, hd=32)], ids=str)
def test_search_contract_equal_on_every_directive(shape):
    jw, tw = JRing(**shape), TRing(**shape)
    small = tw.sl <= 128
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
            if d.backend == "PALLAS_RDMA" and i % 8 == 0 and small:
                assert _report_view(tver.verify_directive(tw, td)) \
                    == _report_view(jver.verify_directive(jw, d2)), d2
            n += 1
    assert n > 400


@pytest.mark.parametrize("name", list(chip_smoke.ring_directives()))
def test_l0_reports_equal_for_the_main_path_directives(name):
    d = chip_smoke.ring_directives()[name]
    jd = jds.directive_from_dict(d.as_dict())
    jw, tw = JRing(), TRing()
    assert tw.check(d, TCTX) == [] and jw.check(jd, JCTX) == []
    assert tw.kernel_knobs(d) == jw.kernel_knobs(jd)
    assert _report_view(tver.verify_directive(tw, d)) \
        == _report_view(jver.verify_directive(jw, jd))


def test_fig3_cuco_point_is_rejected_as_the_reference_rejects_it():
    """fig3's own cuco point keeps PER_PEER granularity, which the ring's
    check refuses for fused exchanges in both packages."""
    d = jds.Directive("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", contexts=2)
    td = tds.directive_from_dict(d.as_dict())
    assert TRing().check(td, TCTX) == JRing().check(d, JCTX) != []


def test_degrade_equal():
    jw, tw = JRing(seq=1000, BH=4), TRing(seq=1000, BH=4)
    assert tw.degrade((0, 1, 2, 3)) is tw
    for live in ((0, 1, 2), (1, 3), (2,)):
        jd, td = jw.degrade(live), tw.degrade(live)
        assert (td.n_dev, td.seq, td.sl, td.BH, td.hd) \
            == (jd.n_dev, jd.seq, jd.sl, jd.BH, jd.hd)
        assert td.fingerprint() == jd.fingerprint()
        assert td.state_bytes_per_rank() == jd.state_bytes_per_rank()
        for d in (jds.CONSERVATIVE, jds.EXPERT_SYSTEMS["FLUX"]):
            td_ = tds.directive_from_dict(d.as_dict())
            assert _cost_view(td.cost_breakdown(td_, TCTX)) \
                == _cost_view(jd.cost_breakdown(d, JCTX))
    assert get_workload("ring_attention").fingerprint() == JRing().fingerprint()


# ------------------------------------------------------------ cascade / fast


def test_fast_path_reaches_level_three_on_a_small_ring():
    w = TRing(BH=2, seq=256, hd=16)
    hw = extract_hardware_context(CPU, H100)
    seed = fast_path(w, CPU, hw)
    assert seed.directive.backend == "PALLAS_RDMA"
    assert seed.candidate.result.level == 3
    assert seed.graph.nodes[0].kind == "collective-permute"
    ev = CascadeEvaluator(w, CPU, hw)
    for name, d in chip_smoke.ring_directives().items():
        r = ev.evaluate(Candidate(d, mutation=name))
        assert r.level == 3, (name, r.diagnostic)


def test_cascade_rejects_a_wrong_ring():
    """A build that drops the causal mask is caught at l2."""
    w = TRing(BH=2, seq=256, hd=16)
    hw = extract_hardware_context(CPU, H100)
    ev = CascadeEvaluator(w, CPU, hw)
    w.build = lambda d, mesh: (lambda q, k, v: ra.ring_attention(
        q, k, v, mesh, causal=False))
    r = ev.evaluate(Candidate(jds.EXPERT_SYSTEMS["FLUX"]))
    assert r.level == 1 and r.rejection == "l2:mismatch"


# ------------------------------------------------------------- chip_smoke


def test_chip_smoke_attention_bounds_from_the_shapes():
    """f32 attention at the 3xTF32 rate (495 / 3 TFLOP/s), as the
    kernels compute it on the tensor cores; bf16 at 989."""
    ms, by, flops, _ = chip_smoke.attn_bound(8, 4096, 64, causal=True)
    assert abs(flops / 1e9 - 17.2) < 0.05 and by == "operations"
    assert abs(ms - 0.104) < 0.001
    ms, by, flops, nbytes = chip_smoke.attn_bound(8, 4096, 64, causal=False)
    assert flops == 4 * 8 * 64 * 4096 * 4096 and abs(ms - 0.208) < 0.001
    assert nbytes == 4 * 8 * 4096 * 64 * 4          # q, k, v in; out
    ms, by, flops, _ = chip_smoke.attn_bound(96, 8192, 64, causal=True)
    assert abs(flops / 1e9 - 824.7) < 0.05 and abs(ms - 5.0) < 0.01
    ms, by, _, nbytes = chip_smoke.attn_bound(8, 4096, 64, esize=2)
    assert nbytes == 4 * 8 * 4096 * 64 * 2 and ms < 0.02   # bf16 rate
