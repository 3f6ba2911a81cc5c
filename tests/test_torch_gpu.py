"""The Hopper moe_dispatch kernel against its plain version, on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Inputs are made with numpy from a seed. Tolerances, max-abs-normalised:
1e-4 on the f32 wire (the kernel sums the K dimension in another order
than cuBLAS; no TF32 on either side), 1e-3 on the int8 wire (a tie may
round the other way after an f32 division).
"""
import pytest
import torch

from repro_torch.kernels import moe_dispatch as kern
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.moe_dispatch import inputs_from_numpy
from torch_port_helpers import numpy_inputs, rel_err


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the main path's variants, and one it does not launch
GPU_VARIANTS = dict(kern.VARIANTS, **{
    "barrier+int8": dict(barrier=True, pipelined=False, wire_i8=True)})


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GPU_VARIANTS))
@pytest.mark.parametrize("shape", [(4, 256, 128, 128, 0, 3.0, 64, True),
                                   (4, 192, 256, 128, 128, 1.0, 32, True),
                                   (2, 128, 64, 192, 64, 2.0, 16, False),
                                   (1, 64, 64, 64, 64, 1.0, 64, True)])
def test_kernel_matches_plain_version(cuda_device, variant, shape):
    """The CUDA kernel against its plain version on the card (1e-4 f32,
    1e-3 int8 wire: a tie may round the other way)."""
    n, T, d, f, fs, skew, B, tight = shape
    arrs = numpy_inputs(n, T, d, f, fs, seed=n + T)
    ts = inputs_from_numpy(*arrs, device=cuda_device)
    shared = (ts[0], ts[3], ts[4]) if fs else None
    counts = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f, skew=skew)._counts(T)
    kw = dict(counts=counts, block_tokens=B, tight=tight, **GPU_VARIANTS[variant])
    before = kern.launches()
    got = kern.moe_dispatch_combine(*ts[:3], shared=shared, **kw)
    want = kern.moe_dispatch_combine_ref(
        *ts[:3], counts=counts, block_tokens=B, tight=tight,
        wire_i8=kw.get("wire_i8", False), shared=shared)
    torch.cuda.synchronize()
    assert kern.launches() == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = 1e-3 if kw.get("wire_i8") else 1e-4
    for g, w in zip(got, want):
        assert rel_err(g.cpu(), w.cpu()) <= tol


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros((4, 64, 100), device=cuda_device)
    w1 = torch.zeros((4, 100, 128), device=cuda_device)
    w2 = torch.zeros((4, 64, 100), device=cuda_device)
    with pytest.raises(ValueError, match="multiples"):
        kern.moe_dispatch_combine(x, w1, w2, counts=[16] * 4)
    with pytest.raises(ValueError, match="float32"):
        kern.moe_dispatch_combine(x.double(), w1, w2, counts=[16] * 4)
