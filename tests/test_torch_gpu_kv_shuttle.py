"""The Hopper kv_shuttle kernel against its plain version, on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_kv_shuttle.py

Inputs are made with numpy from a seed. Tolerances: 1e-4
max-abs-normalised for the projections (the kernel sums the d dimension
in another order than cuBLAS; no TF32 on either side); ``pure`` is a copy,
so its output must equal the plain version's bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_shuttle as kern
from torch_port_helpers import rel_err


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# every realization, and chunkings that split a 64-row GEMM tile
GPU_VARIANTS = dict(kern.VARIANTS, **{
    "fused_counter_kc16": dict(fused=True, counter=True, kv_chunk=16),
    "fused_signal_kc128": dict(fused=True, counter=False, kv_chunk=128),
    "chained_contexts1": dict(chained=True, contexts=1),
})


def _projection_inputs(T, d, dk, device, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((2, T, d), np.float32)
    x[0] = rng.standard_normal((T, d))
    wk = (rng.standard_normal((d, dk)) / np.sqrt(d)).astype(np.float32)
    wv = (rng.standard_normal((d, dk)) / np.sqrt(d)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, wk, wv)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GPU_VARIANTS))
@pytest.mark.parametrize("shape", [(256, 128, 64), (200, 96, 40),
                                   (130, 67, 65), (4096, 512, 128),
                                   (192, 100, 200), (320, 36, 12)])
def test_kernel_matches_plain_version(cuda_device, variant, shape):
    """Every realization at aligned, ragged-row, ragged-column and
    unaligned (d, dk not multiples of 4) shapes, depths that are not a
    multiple of the 32-deep stage (100, 36) and more than one 128-column
    tile (dk 200)."""
    T, d, dk = shape
    x, wk, wv = _projection_inputs(T, d, dk, cuda_device, seed=T + d + dk)
    knobs = GPU_VARIANTS[variant]
    before = kern.launches()
    got = kern.kv_shuttle(x, wk, wv, **knobs)
    want = kern.kv_shuttle_plain(x, wk, wv, **knobs)
    torch.cuda.synchronize()
    assert kern.launches() == before + 1
    for g, w in zip(got, want):
        assert g.shape == (2, T, dk)
        assert bool((g[0] == 0).all())
        assert rel_err(g.cpu(), w.cpu()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["chained", "sequential", "fused_signal",
                                     "fused_counter"])
@pytest.mark.parametrize("rows,width", [(4360, 64), (1000, 13), (96, 8)])
def test_pure_shuttle_is_bit_exact(cuda_device, dtype, variant, rows, width):
    """The cache handoff copies rows verbatim, including row widths whose
    bytes are not a multiple of 16 (the byte-wise path)."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + width)
    kv = torch.zeros((2, 2 * rows, width), dtype=dtype, device=cuda_device)
    kv[0] = torch.randn((2 * rows, width), generator=g,
                        device=cuda_device).to(dtype)
    knobs = dict(kern.VARIANTS[variant], kv_chunk=40)
    got = kern.kv_cache_shuttle(kv, **knobs)
    want = kern.kv_shuttle_plain(kv, pure=True, **knobs)
    torch.cuda.synchronize()
    for gt, w in zip(got, want):
        assert gt.dtype == dtype and torch.equal(gt, w)
    assert torch.equal(got[0][1], kv[0, :rows])
    assert torch.equal(got[1][1], kv[0, rows:])


@pytest.mark.gpu
def test_launch_after_launch_sees_fresh_flags(cuda_device):
    """Back-to-back launches on one stream, reusing the allocator's freed
    flag words: every launch waits on its own arrivals, never a stale
    count from the one before."""
    x, wk, wv = _projection_inputs(512, 256, 64, cuda_device, seed=7)
    want = kern.kv_shuttle_plain(x, wk, wv)
    outs = [kern.kv_shuttle(x, wk, wv, **knobs)
            for _ in range(3) for knobs in kern.VARIANTS.values()]
    torch.cuda.synchronize()
    for got in outs:
        for g, w in zip(got, want):
            assert rel_err(g.cpu(), w.cpu()) <= 1e-4


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros((2, 64, 32), device=cuda_device)
    w = torch.zeros((32, 16), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kern.kv_shuttle(x.double(), w, w)
    with pytest.raises(ValueError, match="project"):
        kern.kv_shuttle(x, torch.zeros((16, 16), device=cuda_device), w)
    with pytest.raises(ValueError, match="stacked"):
        kern.kv_shuttle(x[:1], w, w)
    with pytest.raises(ValueError, match="contexts"):
        kern.kv_shuttle(x, w, w, contexts=0)
    with pytest.raises(ValueError, match=r"\[K; V\]"):
        kern.kv_cache_shuttle(torch.zeros((2, 63, 8), device=cuda_device))


# ------------------------------------------------------------ the wgmma core

# ragged against the wgmma core's tile: rows not a multiple of its 128 rows,
# dk not a multiple of 128 columns, d not a multiple of the 32-deep stage;
# then the KV cell's widths (d 4096 into 8 heads of 128)
WGMMA_SHAPES = [(300, 100, 200), (1000, 4096, 1024)]


def _core_delta(before):
    return {k: v - before.get(k, 0) for k, v in kern.CORE_LAUNCHES.items()
            if v != before.get(k, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
@pytest.mark.parametrize("contexts", [1, 2, 4])
@pytest.mark.parametrize("variant", list(kern.VARIANTS))
def test_wgmma_core_matches_plain_version_at_every_contexts(
        cuda_device, variant, contexts, shape):
    T, d, dk = shape
    x, wk, wv = _projection_inputs(T, d, dk, cuda_device, seed=T + dk)
    knobs = kern.VARIANTS[variant]
    before = dict(kern.CORE_LAUNCHES)
    got = kern.kv_shuttle(x, wk, wv, contexts=contexts, **knobs)
    want = kern.kv_shuttle_plain(x, wk, wv, **knobs)
    torch.cuda.synchronize()
    assert _core_delta(before) == {"wgmma": 1}
    for g, w in zip(got, want):
        assert bool((g[0] == 0).all())
        assert rel_err(g.cpu(), w.cpu()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(130, 67, 65), (200, 98, 50),
                                   (256, 128, 64)])
def test_unaligned_inputs_run_the_mma_sync_core(cuda_device, shape):
    """d or dk not a multiple of 4, or (the last shape) an x that starts
    4 bytes past a 16-byte boundary: tc_gemm.cuh's core, as before."""
    T, d, dk = shape
    x, wk, wv = _projection_inputs(T, d, dk, cuda_device, seed=T)
    if d % 4 == 0 and dk % 4 == 0:
        flat = torch.zeros(x.numel() + 1, device=cuda_device)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(x.shape)
    assert kern.core_for(x, wk, wv) == "mma_sync"
    before = dict(kern.CORE_LAUNCHES)
    for knobs in kern.VARIANTS.values():
        got = kern.kv_shuttle(x, wk, wv, **knobs)
        want = kern.kv_shuttle_plain(x, wk, wv, **knobs)
        for g, w in zip(got, want):
            assert rel_err(g.cpu(), w.cpu()) <= 1e-4
    assert _core_delta(before) == {"mma_sync": len(kern.VARIANTS)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 100, 200), (130, 67, 65)])
@pytest.mark.parametrize("knobs", [
    dict(chained=False), dict(chained=True),
    dict(fused=True, counter=True, kv_chunk=32),
    dict(fused=True, counter=False, kv_chunk=64),
    dict(fused=True, counter=True, kv_chunk=128)])
def test_probe_log_keeps_each_cores_round_order(cuda_device, knobs, shape):
    """The probe build's window log against ``check_log``'s model of the
    round order at each core's tile height (128 rows on the wgmma core,
    64 on mma_sync)."""
    T, d, dk = shape
    x, wk, wv = _projection_inputs(T, d, dk, cuda_device, seed=d)
    ko, vo, events, meta = kern.kv_shuttle_logged(x, wk, wv, contexts=2,
                                                  **knobs)
    assert meta["core"] == kern.core_for(x, wk, wv)
    want = kern.kv_shuttle_plain(x, wk, wv)
    assert rel_err(ko.cpu(), want[0].cpu()) <= 1e-4
    got = kern.check_log(events, **meta)
    assert got["rounds"] == len(kern._units(
        T, dk, knobs.get("kv_chunk", 64) if knobs.get("fused") else T,
        knobs.get("fused", False), False, 1, meta["core"]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(130, 96, 40), (1000, 4096, 1024)])
def test_wgmma_core_alone_matches_plain_product(cuda_device, shape):
    T, d, dk = shape
    x, wk, wv = _projection_inputs(T, d, dk, cuda_device, seed=dk)
    k, v = kern.gemm_core(x[0], wk, wv)
    torch.cuda.synchronize()
    assert rel_err(k.cpu(), (x[0] @ wk).cpu()) <= 1e-4
    assert rel_err(v.cpu(), (x[0] @ wv).cpu()) <= 1e-4


@pytest.mark.gpu
def test_the_kv_cells_shape_takes_the_wgmma_core_once_a_step(cuda_device):
    """KVTransfer's run at the KV cell's widths and directive (the chained
    shuttle): one launch a step, every one on the wgmma core."""
    from repro_torch.core.design_space import Directive
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.workloads import get_workload
    T, d, dk = 757, 4096, 1024
    run = get_workload("kv_transfer", T=T, d=d, dk=dk).build(
        Directive(backend="PALLAS_RDMA", completion="SIGNAL",
                  placement="STREAM_SPLIT", tunables=()),
        VirtualMesh(2, device=cuda_device))
    x, wk, wv = _projection_inputs(T, d, dk, cuda_device, seed=3)
    before, launched = dict(kern.CORE_LAUNCHES), kern.launches()
    for _ in range(3):
        got = run(x, wk, wv)
    torch.cuda.synchronize()
    assert kern.launches() == launched + 3
    assert _core_delta(before) == {"wgmma": 3}
    for g, w in zip(got, kern.kv_shuttle_plain(x, wk, wv)):
        assert rel_err(g.cpu(), w.cpu()) <= 1e-4
