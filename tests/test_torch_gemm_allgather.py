"""The port's GEMM + AllGather slice against the JAX package, on the CPU.

At one rank the reference's Pallas ``gemm_allgather`` runs (interpret
mode: no DMA semaphore is waited on), so the port's plain version
(``gemm_allgather_plain``, which the wrapper computes for CPU tensors) is
held against the executed kernel there; at more ranks the Pallas variants
fail at trace time on this JAX version (ROADMAP queue 3), and the plain
version is held against ``kernels/ref.py::gemm_allgather_ref`` and
``GemmAllGather.reference``. The host and STREAM_SPLIT builds are held
against the reference's XLA builds at four host devices, which run in a
subprocess (the device count is fixed when JAX starts). The search
contract (knobs, schedules, the l0 report, the l3 cost) is compared
directive by directive. Inputs are made with numpy from a seed and handed
to both.

Tolerance: 1e-5 max-abs-normalised (f32, the same GEMM in another
library).
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
from repro.workloads.gemm_allgather import GemmAllGather as JGA
from repro_torch.core import comm_graph
from repro_torch.core import design_space as tds
from repro_torch.core import verify as tver
from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.fast_path import fast_path
from repro_torch.core.hardware import H100, V5E, HardwareContext
from repro_torch.core.hardware import extract_hardware_context
from repro_torch.dist import mesh as vmesh
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import gemm_allgather as kern
from repro_torch.workloads import get_workload
from repro_torch.workloads.gemm_allgather import GemmAllGather as TGA
from repro_torch.workloads.gemm_allgather import inputs_from_numpy
from torch_port_helpers import rel_err, run_jax_devices

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CPU = VirtualMesh(4, device="cpu")


def ga_numpy(n, M_l, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, M_l, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return a, b


# ------------------------------------------------------------ plain version


@pytest.mark.parametrize("knobs", [
    dict(fused=True, counter=False, tile_m=32),
    dict(fused=False, counter=False, tile_m=32),
    dict(fused=True, counter=True, tile_m=16),
    dict(fused=True, counter=True, tile_m=32)], ids=str)
def test_plain_matches_executed_pallas_at_one_rank(knobs):
    from repro.kernels.gemm_allgather import gemm_allgather as jga
    a, b = ga_numpy(1, 64, 32, 48, seed=knobs["tile_m"])
    want = jga(jnp.asarray(a), jnp.asarray(b), make_mesh((1,), ("x",)),
               **knobs)
    got = kern.gemm_allgather_plain(*inputs_from_numpy(a, b, device="cpu"),
                                    **knobs)
    assert got.shape == want.shape == (1, 64, 48)
    assert rel_err(got, want) <= 1e-5


KNOBS = [dict(fused=f, counter=c, tile_m=tm, contexts=cx)
         for f, c, tm, cx in itertools.product(
             (True, False), (True, False), (128, 16, 48, 100), (1, 2))]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_plain_matches_reference_oracles(n, knobs):
    a, b = ga_numpy(n, 96, 40, 24, seed=n + len(str(knobs)))
    ins = inputs_from_numpy(a, b, device="cpu")
    want = jref.gemm_allgather_ref(jnp.asarray(a), jnp.asarray(b))
    also = JGA(n_dev=n, M=96 * n, K=40, N=24).reference(jnp.asarray(a),
                                                         jnp.asarray(b))
    got = kern.gemm_allgather(*ins, VirtualMesh(n, device="cpu"), **knobs)
    assert got.shape == want.shape == (n, n * 96, 24)
    assert rel_err(got, want) <= 1e-5 and rel_err(got, also) <= 1e-5
    assert torch.equal(got, kern.gemm_allgather_plain(*ins, **knobs))


def test_wrapper_checks_its_arguments():
    a, b = torch.zeros((4, 8, 6)), torch.zeros((6, 5))
    with pytest.raises(ValueError, match=r"\(n, M_l, K\)"):
        kern.gemm_allgather(a, torch.zeros((5, 5)))
    with pytest.raises(ValueError, match="contexts"):
        kern.gemm_allgather(a, b, contexts=0)
    with pytest.raises(ValueError, match="mesh of 2"):
        kern.gemm_allgather(a, b, VirtualMesh(2, device="cpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kern.gemm_allgather(a.to("meta"), b.to("meta"))
    assert kern.launches() == 0           # the plain version counts nothing


def test_variant_names():
    assert kern.variant_name(fused=False, M_l=1024) == "deferred"
    assert kern.variant_name(fused=True, M_l=1024) == "fused_signal"
    assert kern.variant_name(fused=True, counter=True, M_l=1024) \
        == "fused_counter"
    assert kern.variant_name(fused=True, counter=True, tile_m=32, M_l=1024) \
        == "fused_counter_tm32"
    # a tile that does not divide the slab is sanitized first
    assert kern.variant_name(fused=True, counter=True, tile_m=100, M_l=96) \
        == "fused_counter_tm96"
    for name, knobs in kern.VARIANTS.items():
        assert kern.variant_name(M_l=1024, **knobs) == name


# ------------------------------------------------------------- the split


@pytest.mark.parametrize("shape,padded", [
    ((4, 1024, 4096, 4096), (1024, 4096, 4096)),     # aligned: no pad
    ((4, 200, 96, 72), (256, 96, 128)),               # ragged rows, columns
    ((2, 130, 67, 65), (256, 96, 128))], ids=str)     # K, N not multiples of 4
def test_scratch_shapes_padded_to_whole_tiles(shape, padded):
    n, M_l, K, N = shape
    assert kern.padded(M_l, K, N) == padded
    M_p, K_p, N_p = padded
    assert kern.scratch_shapes(n, M_l, K, N) == ((2, n, M_p, K_p),
                                                 (2, n, N_p, K_p))
    assert M_p % kern.TILE_M == 0 and N_p % kern.TILE_N == 0
    assert K_p % kern.TILE_K == 0


def test_split_plain_is_exact_and_zero_padded():
    """hi is x rounded to TF32 (13 low bits clear), hi + lo == x exactly,
    A keeps its layout and B arrives transposed, one replica a rank, the
    pad zero."""
    a, b = (torch.from_numpy(x) for x in ga_numpy(3, 130, 67, 65, seed=5))
    sa, sb = kern.split_operands(a, b)        # the CPU takes the plain split
    assert (sa.shape, sb.shape) == kern.scratch_shapes(3, 130, 67, 65)
    for hi in (sa[0], sb[0]):
        assert not (hi.view(torch.int32) & 0x1FFF).any()
    full_a, full_b = sa[0] + sa[1], sb[0] + sb[1]
    assert torch.equal(full_a[:, :130, :67], a)
    for r in range(3):
        assert torch.equal(full_b[r, :65, :67], b.t())
    assert not full_a[:, 130:].any() and not full_a[:, :, 67:].any()
    assert not full_b[:, 65:].any() and not full_b[:, :, 67:].any()
    # |lo| is at most half a TF32 step of x
    assert bool((sa[1].abs() <= a.abs().max() * 2.0 ** -11).all())


def test_split_products_match_the_reference():
    """The kernel's arithmetic on the CPU: the three TF32 products
    a_lo b_hi + a_hi b_lo + a_hi b_hi of the plain split, lo read as the
    tensor core reads it (its top 19 bits), against the reference's
    oracle within the kernel's 1e-4 gate."""
    n, M_l, K, N = 2, 64, 256, 40
    a, b = ga_numpy(n, M_l, K, N, seed=9)
    sa, sb = kern.split_operands(*inputs_from_numpy(a, b, device="cpu"))

    def tf32(x):            # the tensor core keeps 10 mantissa bits
        return (x.view(torch.int32) & -0x2000).view(torch.float32).double()

    ah, al = tf32(sa[0]), tf32(sa[1])
    bh, bl = tf32(sb[0]), tf32(sb[1])
    t = lambda m: m.transpose(1, 2)  # noqa: E731
    c = al @ t(bh) + ah @ t(bl) + ah @ t(bh)
    got = c[:, :M_l, :N].float().reshape(n * M_l, N)
    want = jref.gemm_allgather_ref(jnp.asarray(a), jnp.asarray(b))[0]
    assert rel_err(got, want) <= 1e-4
    # one TF32 product alone is not f32-accurate
    assert rel_err((ah @ t(bh))[:, :M_l, :N].float().reshape(n * M_l, N),
                   want) > 1e-4


# ------------------------------------------------------------- the mesh


def test_mesh_all_gather_and_recorder():
    t = torch.arange(24.0).reshape(3, 2, 4)
    m = VirtualMesh(3, device="cpu")
    with vmesh.record() as events:
        tiled = m.all_gather(t)
        stacked = m.all_gather(t, tiled=False)
    assert tiled.shape == (3, 6, 4) and stacked.shape == (3, 3, 2, 4)
    for r in range(3):
        assert torch.equal(tiled[r], t.reshape(6, 4))
        assert torch.equal(stacked[r], t)
    assert [ev.kind for ev in events] == ["all-gather", "all-gather"]
    assert events[0].shape == (2, 4) and events[0].payload_bytes == 2 * 4 * 4
    with pytest.raises(ValueError, match="n=3"):
        m.all_gather(t[:2])


def test_comm_graph_matches_reference_at_one_rank():
    from repro.core import comm_graph as jcg
    a, b = ga_numpy(1, 64, 32, 48)
    jw, tw = JGA(n_dev=1, M=64, K=32, N=48), TGA(n_dev=1, M=64, K=32, N=48)
    jg = jcg.analyze(jw.host_baseline(make_mesh((1,), ("x",))),
                     jnp.asarray(a), jnp.asarray(b))
    tg = comm_graph.analyze(tw.host_baseline(VirtualMesh(1, device="cpu")),
                            *inputs_from_numpy(a, b, device="cpu"))
    assert [nd.kind for nd in tg.nodes] == [nd.kind for nd in jg.nodes] \
        == ["all-gather"]
    assert tg.collective_bytes == jg.collective_bytes == 64 * 48 * 4
    assert tg.nodes[0].operands == jg.nodes[0].operands
    # the reference's trailing compute phase is the `[None]` its shard_map
    # layout needs after the gather; the stacked layout needs none
    assert [p[0] for p in tg.phases()] == [p[0] for p in jg.phases()][:2] \
        == ["compute", "communicate"]
    assert tg.nodes[0].producers


# ----------------------------------------------------------------- builders

HOST_BUILDS = """
import sys
import jax.numpy as jnp
import numpy as np
from repro.launch.mesh import make_mesh
from repro.workloads.gemm_allgather import GemmAllGather
d = np.load(sys.argv[1])
a, b = jnp.asarray(d["a"]), jnp.asarray(d["b"])
n, M_l, K = a.shape
w = GemmAllGather(n_dev=n, M=n * M_l, K=K, N=b.shape[1])
mesh = make_mesh((n,), ("x",))
out = {"host": w.host_baseline(mesh)(a, b)}
for c in (1, 3, 4):
    out[f"stream_split{c}"] = w._stream_split(mesh, c)(a, b)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def jax_host_builds(tmp_path_factory):
    a, b = ga_numpy(4, 48, 32, 40, seed=6)
    got = run_jax_devices(HOST_BUILDS, {"a": a, "b": b},
                          str(tmp_path_factory.mktemp("ga_host")))
    return (a, b), got


@pytest.mark.parametrize("name", ["host", "stream_split1", "stream_split3",
                                  "stream_split4"])
def test_host_builds_match_the_reference_builds_at_four_ranks(
        jax_host_builds, name):
    (a, b), want = jax_host_builds
    w = TGA(n_dev=4, M=4 * 48, K=32, N=40)
    run = w.host_baseline(CPU) if name == "host" \
        else w._stream_split(CPU, int(name[-1]))
    got = run(*inputs_from_numpy(a, b, device="cpu"))
    assert got.shape == want[name].shape == (4, 4 * 48, 40)
    assert rel_err(got, want[name]) <= 1e-5


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


TUNINGS = ((), (("tile_m", 32),), (("tile_m", 100),), (("chunks", 3),),
           (("tile_m", 16), ("chunks", 2)))


@pytest.mark.parametrize("M", [4096, 512])
def test_search_contract_equal_on_every_directive(M):
    jw, tw = JGA(M=M), TGA(M=M)
    n = 0
    for i, d in enumerate(jds.enumerate_valid(**jw.traits(JCTX))):
        for tun in TUNINGS:
            if tun and i % 4:
                continue
            d2 = dataclasses.replace(d, tunables=tun)
            td = tds.directive_from_dict(d2.as_dict())
            assert tw.check(td, TCTX) == jw.check(d2, JCTX)
            assert tw.kernel_knobs(td) == jw.kernel_knobs(d2), d2
            assert tw.kernel_knobs(td, 96) == jw.kernel_knobs(d2, 96), d2
            js, ts = jw.collective_schedule(d2), tw.collective_schedule(td)
            assert (ts is None) == (js is None)
            if ts is not None:
                assert dataclasses.astuple(ts) == dataclasses.astuple(js)
            assert _cost_view(tw.cost_breakdown(td, TCTX)) \
                == _cost_view(jw.cost_breakdown(d2, JCTX)), d2
            assert tw.analytic_cost(td, TCTX) == jw.analytic_cost(d2, JCTX)
            if d.backend == "PALLAS_RDMA" and i % 8 == 0 and M < 4096:
                assert _report_view(tver.verify_directive(tw, td)) \
                    == _report_view(jver.verify_directive(jw, d2)), d2
            n += 1
    assert n > 500


@pytest.mark.parametrize("name", list(chip_smoke.ga_directives()))
def test_l0_reports_equal_for_the_main_path_directives(name):
    d = chip_smoke.ga_directives()[name]
    jd = jds.directive_from_dict(d.as_dict())
    jw, tw = JGA(), TGA()
    assert tw.check(d, TCTX) == [] and jw.check(jd, JCTX) == []
    assert tw.kernel_knobs(d) == jw.kernel_knobs(jd)
    assert _report_view(tver.verify_directive(tw, d)) \
        == _report_view(jver.verify_directive(jw, jd))


def test_degrade_equal():
    jw, tw = JGA(M=1000, K=256, N=128), TGA(M=1000, K=256, N=128)
    assert tw.degrade((0, 1, 2, 3)) is tw
    for live in ((0, 1, 2), (1, 3), (2,)):
        jd, td = jw.degrade(live), tw.degrade(live)
        assert (td.n_dev, td.M, td.K, td.N) == (jd.n_dev, jd.M, jd.K, jd.N)
        assert td.fingerprint() == jd.fingerprint()
        assert td.state_bytes_per_rank() == jd.state_bytes_per_rank()
        for d in (jds.CONSERVATIVE, jds.EXPERT_SYSTEMS["FLUX"]):
            td_ = tds.directive_from_dict(d.as_dict())
            assert _cost_view(td.cost_breakdown(td_, TCTX)) \
                == _cost_view(jd.cost_breakdown(d, JCTX))
    assert tw.fingerprint() == jw.fingerprint()
    assert get_workload("gemm_allgather").fingerprint() == JGA().fingerprint()


# ------------------------------------------------------------ cascade / fast


def test_fast_path_reaches_level_three_on_a_small_gemm_allgather():
    w = TGA(M=256, K=64, N=48)
    hw = extract_hardware_context(CPU, H100)
    seed = fast_path(w, CPU, hw)
    assert seed.directive.backend == "PALLAS_RDMA"
    assert seed.candidate.result.level == 3
    assert seed.graph.nodes[0].kind == "all-gather"
    ev = CascadeEvaluator(w, CPU, hw)
    for name, d in chip_smoke.ga_directives().items():
        r = ev.evaluate(Candidate(d, mutation=name))
        assert r.level == 3, (name, r.diagnostic)


def test_cascade_rejects_a_wrong_gemm_allgather():
    """A build that gathers the ranks' slabs in the wrong order is caught
    at l2."""
    w = TGA(M=256, K=64, N=48)
    hw = extract_hardware_context(CPU, H100)
    ev = CascadeEvaluator(w, CPU, hw)
    good = w.build
    w.build = lambda d, mesh: (lambda a, b: good(d, mesh)(a.flip(0), b))
    r = ev.evaluate(Candidate(jds.EXPERT_SYSTEMS["FLUX"]))
    assert r.level == 1 and r.rejection == "l2:mismatch"


# ------------------------------------------------------------- chip_smoke


def test_chip_smoke_ga_phases_on_the_cpu():
    """The smoke's gemm_allgather phases at a tiny size on the CPU, where
    the wrapper computes the plain version (every error 0, no launch
    counted)."""
    recs = chip_smoke.phase_ga_kernels("cpu", chip_smoke.ga_workload(
        small=True), iters=1)
    assert len(recs) == len(kern.VARIANTS)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for rec in recs:
        assert keys <= set(rec) and rec["max_abs_err"] == 0.0
        assert rec["_path"] == "ga_main" and rec["route"] == "cuda"
        assert os.path.exists(os.path.join(ROOT, rec["source"]))
        assert rec["replaces"] == "src/repro/kernels/gemm_allgather.py:193"
    assert chip_smoke.phase_ga_main(
        "cpu", chip_smoke.ga_workload(small=True)) == {}


def test_chip_smoke_ga_bound_from_the_shapes():
    ms, by, flops, nbytes = chip_smoke.ga_bound(4, 1024, 4096, 4096)
    assert flops == 2 * 4 * 1024 * 4096 * 4096     # 137.4 GFLOP
    assert abs(flops / 1e9 - 137.4) < 0.05
    # the kernel's GEMM runs as 3xTF32: three TF32 products per multiply-add
    assert by == "operations" and abs(ms - 0.833) < 0.0005
    assert abs(ms - flops / (495e12 / 3) * 1e3) < 1e-12
    assert abs(nbytes / 1e6 - 402.7) < 0.1          # a, b in; 4 outputs


def test_chip_smoke_ga_core_on_the_cpu():
    """The smoke's ga_core line at a tiny size on the CPU, where the
    wrappers compute their plain versions (nothing launched)."""
    rec = chip_smoke.phase_ga_core("cpu", chip_smoke.ga_workload(small=True),
                                   iters=1)
    for key in ("split_ms", "split1_ms", "one_ms", "matmul_ms", "bound_ms"):
        assert rec[key] > 0
    assert rec["gemm_ms"] == rec["one_ms"] - rec["split1_ms"]
    assert rec["knobs"] == {}             # the -D builds need the card
    assert kern.launches() == 0


def test_chip_smoke_reads_ptxas_resources():
    lines = [
        "ptxas info    : Compiling entry function '_Z8other_kernelv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z8other_kernelv",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_Z21gemm_allgather_kernel8GaParamsi' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z21gemm_allgather_kernel8GaParamsi",
        "    40 bytes stack frame, 0 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 162 registers, used 2 barriers"]
    assert chip_smoke.ptxas_resources(lines, "gemm_allgather_kernel") == (
        162, 0, 4)
    assert chip_smoke.ptxas_resources([], "gemm_allgather_kernel") == (
        None, None, None)
