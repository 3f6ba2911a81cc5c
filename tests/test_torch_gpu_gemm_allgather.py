"""The Hopper gemm_allgather kernel against its plain version, on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_gemm_allgather.py

Inputs are made with numpy from a seed. Tolerance: 1e-4 max-abs-normalised
(the kernel's 3xTF32 products carry f32 accuracy and sum the K dimension
in another order than cuBLAS, which runs without TF32).
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


# every realization, and chunks smaller than, half of and straddling a
# 128-row GEMM tile
GPU_VARIANTS = dict(kern.VARIANTS, **{
    "fused_counter_tm16": dict(fused=True, counter=True, tile_m=16),
    "fused_counter_tm64": dict(fused=True, counter=True, tile_m=64),
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
                                   (1, 300, 96, 136),
                                   (4, 1024, 512, 512),
                                   (2, 256, 7168, 512),
                                   (4, 1024, 4096, 4096)])
def test_kernel_matches_plain_version(cuda_device, variant, shape):
    """Every realization at aligned, ragged-row, ragged-column, unaligned
    (K, N not multiples of 4) and odd-rank shapes, at one rank (no peer),
    at K = 7168 (the depth the summed-apart partials must carry within the
    gate) and at GemmAllGather's defaults."""
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
def test_back_to_back_launches_split_their_own_operands(cuda_device):
    """Two launches in a row on one stream, on other inputs: the second
    reuses the first's freed scratch and must read its own fresh split."""
    a1, b1 = _inputs(3, 384, 160, 256, cuda_device, seed=11)
    a2, b2 = _inputs(3, 384, 160, 256, cuda_device, seed=12)
    for knobs in GPU_VARIANTS.values():
        got1 = kern.gemm_allgather(a1, b1, **knobs)
        got2 = kern.gemm_allgather(a2, b2, **knobs)
        torch.cuda.synchronize()
        assert rel_err(got1.cpu(), kern.gemm_allgather_plain(a1, b1).cpu()) \
            <= 1e-4
        assert rel_err(got2.cpu(), kern.gemm_allgather_plain(a2, b2).cpu()) \
            <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 256, 128, 128), (2, 130, 67, 65),
                                   (3, 200, 96, 72)])
def test_split_matches_plain_version_bit_for_bit(cuda_device, shape):
    """The split phase alone: each rank's A and B^T as TF32 hi / lo,
    zero-padded to whole tiles, equal to the plain split."""
    n, M_l, K, N = shape
    a, b = _inputs(n, M_l, K, N, cuda_device, seed=sum(shape))
    got = kern.split_operands(a, b)
    want = kern.split_operands_plain(a, b)
    torch.cuda.synchronize()
    for g, w, shp in zip(got, want, kern.scratch_shapes(n, M_l, K, N)):
        assert g.shape == w.shape == shp
        assert torch.equal(g, w)


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
