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
