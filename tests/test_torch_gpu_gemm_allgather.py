"""The Hopper gemm_allgather kernel against its plain version, on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_gemm_allgather.py

Inputs are made with numpy from a seed. Tolerance: 1e-4 max-abs-normalised
(the kernel sums the K dimension in another order than cuBLAS; no TF32 on
either side).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm_allgather as kern
from torch_port_helpers import rel_err


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# every realization, and chunks smaller and larger than a 64-row GEMM tile
GPU_VARIANTS = dict(kern.VARIANTS, **{
    "fused_counter_tm16": dict(fused=True, counter=True, tile_m=16),
    "fused_counter_tm96": dict(fused=True, counter=True, tile_m=96),
    "deferred_contexts1": dict(fused=False, contexts=1),
})


def _inputs(n, M_l, K, N, device, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, M_l, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (a, b)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GPU_VARIANTS))
@pytest.mark.parametrize("shape", [(4, 256, 128, 128), (4, 200, 96, 72),
                                   (2, 130, 67, 65), (3, 64, 64, 40),
                                   (4, 1024, 512, 512),
                                   (4, 1024, 4096, 4096)])
def test_kernel_matches_plain_version(cuda_device, variant, shape):
    """Every realization at aligned, ragged-row, ragged-column, unaligned
    (K, N not multiples of 4) and odd-rank shapes, and at GemmAllGather's
    defaults."""
    n, M_l, K, N = shape
    a, b = _inputs(n, M_l, K, N, cuda_device, seed=sum(shape))
    knobs = GPU_VARIANTS[variant]
    before = kern.launches()
    got = kern.gemm_allgather(a, b, **knobs)
    want = kern.gemm_allgather_plain(a, b, **knobs)
    torch.cuda.synchronize()
    assert kern.launches() == before + 1
    assert got.shape == (n, n * M_l, N)
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
def test_launch_after_launch_sees_fresh_flags(cuda_device):
    """Back-to-back launches on one stream, reusing the allocator's freed
    flag words: every launch waits on its own arrivals."""
    a, b = _inputs(4, 512, 256, 192, cuda_device, seed=7)
    want = kern.gemm_allgather_plain(a, b)
    outs = [kern.gemm_allgather(a, b, **knobs)
            for _ in range(3) for knobs in GPU_VARIANTS.values()]
    torch.cuda.synchronize()
    for got in outs:
        assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    a = torch.zeros((4, 64, 32), device=cuda_device)
    b = torch.zeros((32, 16), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kern.gemm_allgather(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        kern.gemm_allgather(a.transpose(1, 2).contiguous().transpose(1, 2),
                            b)
    with pytest.raises(ValueError, match=r"\(n, M_l, K\)"):
        kern.gemm_allgather(a, torch.zeros((16, 16), device=cuda_device))
    with pytest.raises(ValueError, match="contexts"):
        kern.gemm_allgather(a, b, contexts=0)
