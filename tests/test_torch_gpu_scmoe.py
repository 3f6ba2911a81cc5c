"""``moe_dispatch.cu`` on a table of rows per (source, destination) pair,
and LongCat-Flash's ScMoE double-layer through it, on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_scmoe.py

Tolerances as ``tests/test_torch_gpu.py``'s: 1e-4 max-abs-normalised on
the f32 wire (3xTF32 sums K in another order than cuBLAS, TF32 off on
both sides), 1e-3 on the int8 wire.
"""
import pytest
import torch

from repro_torch.core.design_space import EXPERT_SYSTEMS
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import moe_dispatch as kern
from repro_torch.models import longcat_ref
from repro_torch.workloads import get_workload
from repro_torch.workloads.scmoe import record_routes
from torch_port_helpers import rel_err


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


VARIANTS = dict(kern.VARIANTS, **{
    "barrier+int8": dict(barrier=True, pipelined=False, wire_i8=True)})

# rows of each (source, expert) pair; T = 200 rows a source
TABLES = {
    "router": [[30, 0, 17, 64, 65, 1, 0, 9], [12, 12, 12, 12, 12, 12, 12, 12],
               [0, 0, 0, 0, 0, 0, 0, 0], [200, 0, 0, 0, 0, 0, 0, 0],
               [1, 2, 3, 4, 5, 6, 7, 8], [64, 64, 0, 64, 0, 0, 0, 8],
               [0, 50, 0, 50, 0, 50, 0, 50], [25, 25, 25, 25, 25, 25, 25, 24]],
    "no_rows_into_2": [[10, 20, 0, 30], [40, 0, 0, 1], [0, 0, 0, 0],
                       [70, 70, 0, 60]],
    "empty": [[0] * 4] * 4,
    # packed arrivals: microblocks that span two or three sources
    "across_edges": [[40, 63, 65, 30], [64, 1, 70, 60], [0, 0, 0, 0],
                     [66, 64, 2, 63]],
}


def _operands(n, T, d, f, fs, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    x = torch.randn((n, T, d), **kw)
    w1 = torch.randn((n, d, 2 * f), **kw) / d ** 0.5
    w2 = torch.randn((n, f, d), **kw) / f ** 0.5
    xs = torch.randn((n, 48, d), **kw)
    s1 = torch.randn((d, 2 * fs), **kw) / d ** 0.5
    s2 = torch.randn((fs, d), **kw) / fs ** 0.5
    return x, w1, w2, (xs, s1, s2)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("shared", [False, True])
def test_pair_table_kernel_matches_plain_version(cuda_device, variant, table,
                                                 shared):
    """Each source's runs through their expert, the rows past them zero,
    FFN1 (a second stream over other rows than the routed ones) beside."""
    counts = TABLES[table]
    n = len(counts)
    x, w1, w2, sh = _operands(n, 200, 128, 128, 256, cuda_device, n)
    kw = dict(counts=counts, block_tokens=64, tight=True, **VARIANTS[variant])
    before = kern.launches()
    got = kern.moe_dispatch_combine(x, w1, w2, shared=sh if shared else None,
                                    **kw)
    want = kern.moe_dispatch_combine_ref(
        x, w1, w2, counts=counts, wire_i8=kw.get("wire_i8", False),
        shared=sh if shared else None)
    torch.cuda.synchronize()
    assert kern.launches() == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = 1e-3 if kw.get("wire_i8") else 1e-4
    for g, w in zip(got, want):
        assert rel_err(g.cpu(), w.cpu()) <= tol
    for s, row in enumerate(counts):       # rows routed nowhere: zero
        assert not got[0][s, sum(row):].any()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_scmoe_step_on_the_card_matches_the_reference(cuda_device, seed):
    """The FLUX build (router and FFN2 on gemm_core, one moe_dispatch.cu
    launch with FFN1 as its second stream) against longcat_ref with the
    program's picks, which lie among the reference's own top k."""
    w = get_workload("scmoe_step", n_dev=8, tokens_per_rank=64, d=256,
                     f=128, f_dense=512, n_experts=64, n_zero=32, topk=12)
    mesh = VirtualMesh(8, device=cuda_device)
    x = w.example_inputs(seed, mesh)
    run = w.build(EXPERT_SYSTEMS["FLUX"], mesh)
    before = kern.launches()
    with record_routes() as routes:
        got = run(*x)
    torch.cuda.synchronize()
    assert kern.launches() == before + 1
    layer = dict(zip(longcat_ref.LAYER_KEYS, x[1:]))
    want, _, gap = longcat_ref.double_layer(
        x[0], layer, routes[0], n_experts=64, topk=12, scale=6.0, eps=1e-5)
    assert gap < 1e-6
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4
    host = w.build(EXPERT_SYSTEMS["TokenWeave"], mesh)(*x)
    assert rel_err(host.cpu(), want.cpu()) <= 1e-4
