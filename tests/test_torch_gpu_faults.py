"""The Hopper kernels on the survivors of a dropped rank, on the card.

Each workload drops rank 1 (``FaultPlan("drop-rank-1")``) and runs its
``degrade``d instance, unpadded, on 3 ranks: moe_dispatch with the
respilled, unequal counts of ``MoEDispatch`` and ``ServingStep`` (the
elided dummy rounds), gemm_allgather at ``M_l = ceil(4096 / 3) = 1366``
(2 x 683: a 2-row COUNTER chunk), the ring at ``Sl = 1366`` (a 2-row
``kv_chunk``, a ragged last 64-row piece). Every variant a directive can
pick there is held against its plain version, and every Table-3 point
runs the degraded cascade to level 3 on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_faults.py

Inputs are made with numpy from a seed. Tolerances, max-abs-normalised:
1e-4 in f32 (sums in another order, 3xTF32 products), 1e-3 on moe's int8
wire (a tie may round the other way); the bf16 ring each element within
one bf16 step of its plain version plus 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cascade import Candidate, CascadeEvaluator
from repro_torch.core.design_space import EXPERT_SYSTEMS
from repro_torch.core.faults import DROPPED_PEER, FaultPlan, FaultSpec
from repro_torch.core.hardware import H100, extract_hardware_context
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import gemm_allgather as ga
from repro_torch.kernels import moe_dispatch as moe
from repro_torch.kernels import ring_attention as ra
from repro_torch.workloads.gemm_allgather import GemmAllGather
from repro_torch.workloads.kv_transfer import KVTransfer
from repro_torch.workloads.moe_dispatch import MoEDispatch, inputs_from_numpy
from repro_torch.workloads.ring_attention import RingAttention
from repro_torch.workloads.serving import ServingStep
from torch_port_helpers import numpy_inputs, rel_err

DROP1 = FaultPlan("drop-rank-1", (FaultSpec(DROPPED_PEER, rank=1),))
WORKLOADS = {"moe_dispatch": MoEDispatch, "serving_step": ServingStep,
             "gemm_allgather": GemmAllGather,
             "ring_attention": RingAttention, "kv_transfer": KVTransfer}


def degraded(name):
    w = WORKLOADS[name]()
    return w.degrade(DROP1.live_ranks(w.n_dev))


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_degraded_shapes_are_the_workloads_own():
    """The shapes below are each workload's ``degrade``, not a padding."""
    m, s = degraded("moe_dispatch"), degraded("serving_step")
    assert (m.n_dev, list(m._counts(256))) == (3, [174, 19, 63])
    assert (s.n_dev, list(s._counts(256))) == (3, [107, 85, 64])
    g, r = degraded("gemm_allgather"), degraded("ring_attention")
    assert (g.n_dev, g.M // g.n_dev) == (3, 1366)
    assert g.kernel_knobs(EXPERT_SYSTEMS["FLUX"])["tile_m"] == 2
    assert (r.n_dev, r.sl) == (3, 1366)
    assert ra.schedule_for(3, r.sl, fused=True).kv_chunk == 2
    assert degraded("kv_transfer").solo


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(moe.VARIANTS))
@pytest.mark.parametrize("name", ["moe_dispatch", "serving_step"])
def test_moe_on_the_survivors_matches_plain_version(cuda_device, name,
                                                    variant):
    w = degraded(name)
    T = 256
    fs = w.f_shared if w.second_stream else 0
    ts = inputs_from_numpy(*numpy_inputs(w.n_dev, T, w.d, w.f, fs,
                                         seed=len(name)), device=cuda_device)
    shared = (ts[0], ts[3], ts[4]) if fs else None
    knobs = moe.VARIANTS[variant]
    counts = [int(c) for c in w._counts(T)]
    before = moe.launches()
    got = moe.moe_dispatch_combine(*ts[:3], counts=counts, block_tokens=64,
                                   tight=True, shared=shared, **knobs)
    want = moe.moe_dispatch_combine_ref(
        *ts[:3], counts=counts, block_tokens=64, tight=True,
        wire_i8=knobs.get("wire_i8", False), shared=shared)
    torch.cuda.synchronize()
    assert moe.launches() == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = 1e-3 if knobs.get("wire_i8") else 1e-4
    for g, wt in zip(got, want):
        assert rel_err(g.cpu(), wt.cpu()) <= tol


@pytest.fixture(scope="module")
def ga_inputs():
    w = degraded("gemm_allgather")
    rng = np.random.default_rng(3)
    a = rng.standard_normal((w.n_dev, w.M // w.n_dev, w.K), np.float32)
    b = rng.standard_normal((w.K, w.N), np.float32) / np.float32(
        np.sqrt(w.K))
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(ga.VARIANTS))
def test_gemm_allgather_on_the_survivors_matches_plain_version(
        cuda_device, ga_inputs, variant):
    """At M_l = 1366 every COUNTER chunk sanitizes to 2 rows (683 flags a
    source), the slab pads to 11 whole 128-row GEMM tiles."""
    a, b = (torch.from_numpy(x).to(cuda_device) for x in ga_inputs)
    knobs = ga.VARIANTS[variant]
    before = ga.launches()
    got = ga.gemm_allgather(a, b, **knobs)
    want = ga.gemm_allgather_plain(a, b, **knobs)
    torch.cuda.synchronize()
    assert ga.launches() == before + 1
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.fixture(scope="module")
def ring_inputs():
    w = degraded("ring_attention")
    rng = np.random.default_rng(4)
    return [rng.standard_normal((w.n_dev, w.BH, w.sl, w.hd), np.float32)
            for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(ra.VARIANTS)
                         + list(ra.BF16_VARIANTS))
def test_ring_on_the_survivors_matches_plain_version(cuda_device, ring_inputs,
                                                     variant):
    """At Sl = 1366 the fused chunks sanitize to 2 rows (683 a shard) and
    the last 64-row piece of each bh holds 22 rows."""
    bf16 = variant in ra.BF16_VARIANTS
    q, k, v = (torch.from_numpy(x).to(cuda_device).to(
        torch.bfloat16 if bf16 else torch.float32) for x in ring_inputs)
    knobs = (ra.BF16_VARIANTS if bf16 else ra.VARIANTS)[variant]
    before = ra.launches()
    got = ra.ring_attention(q, k, v, **knobs)
    want = ra.ring_attention_plain(q, k, v, **knobs)
    torch.cuda.synchronize()
    assert ra.launches() == before + 1
    if bf16:
        g, wt = got.float().cpu(), want.float().cpu()
        assert bool(torch.isfinite(g).all())
        assert float(((g - wt).abs() / (2.0 ** -7 * wt.abs() + 1e-4)).max()) \
            <= 1.0
    else:
        assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("point", list(EXPERT_SYSTEMS))
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_degraded_cascade_reaches_level_3_on_the_card(cuda_device, name,
                                                      point):
    w = degraded(name)
    mesh = VirtualMesh(w.n_dev, device=cuda_device)
    ev = CascadeEvaluator(w, mesh, extract_hardware_context(mesh, H100))
    res = ev.evaluate(Candidate(EXPERT_SYSTEMS[point]))
    assert res.level == 3, res.diagnostic
    assert res.record.device.startswith("cuda")
