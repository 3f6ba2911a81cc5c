"""The Hopper moe_dispatch kernel against its plain version, on the card,
and each kernelized point of the paper's figures (``repro_torch.figures``:
moe_dispatch, kv_shuttle, gemm_allgather, ring_attention) at a mid shape.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Inputs are made with numpy from a seed. Tolerances, max-abs-normalised:
1e-4 on the f32 wire (the kernel sums the K dimension in another order
than cuBLAS; no TF32 on either side), 1e-3 on the int8 wire (a tie may
round the other way after an f32 division).
"""
import numpy as np
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


# the main path's variants, and ones it does not launch: combine_tile 32
# (flag chunks of half a 64-row GEMM tile), and BARRIER, DEFERRED and
# pipelined SIGNAL on the int8 wire (its rows dequantized by the core's
# converters in 128-row tiles)
GPU_VARIANTS = dict(kern.VARIANTS, **{
    "tile_fused_ct32": dict(tile_fused=True, combine_tile=32),
    "barrier+int8": dict(barrier=True, pipelined=False, wire_i8=True),
    "deferred_signal+int8": dict(pipelined=False, wire_i8=True),
    "pipelined_signal+int8": dict(pipelined=True, wire_i8=True)})


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GPU_VARIANTS))
@pytest.mark.parametrize("shape", [(4, 256, 128, 128, 0, 3.0, 64, True),
                                   (4, 192, 256, 128, 128, 1.0, 32, True),
                                   (2, 128, 64, 192, 64, 2.0, 16, False),
                                   (1, 64, 64, 64, 64, 1.0, 64, True),
                                   (3, 320, 192, 64, 64, 2.0, 64, True),
                                   (2, 384, 128, 128, 128, 1.0, 128, True),
                                   (4, 200, 64, 64, 128, 4.0, 64, False)])
def test_kernel_matches_plain_version(cuda_device, variant, shape):
    """The CUDA kernel against its plain version on the card (1e-4 f32,
    1e-3 int8 wire: a tie may round the other way). The shapes take both
    token tiles of the core: 128 rows where a segment has more than 64
    (two or more microblocks of a source, B = 128, the second stream's
    rows), 64 for a 64-row microblock and a segment's last 64 or fewer;
    rows that are not a multiple of either, and (not ``tight``) microblocks
    and tiles with no token row."""
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
@pytest.mark.parametrize("variant", list(GPU_VARIANTS))
@pytest.mark.parametrize("counts,shared", [([125, 1, 0, 2], False),
                                           ([0, 128, 0, 0], True),
                                           ([1, 0, 127, 0], True)])
@pytest.mark.parametrize("tight", [True, False])
def test_kernel_with_experts_of_zero_or_one_row(cuda_device, variant, counts,
                                                shared, tight):
    """Ranks whose expert gets 0 or 1 rows: each keeps its minimum of one
    routed CTA (and one second-stream CTA), dispatches its own tokens and
    assembles; the busy expert gets the rest of the grid. Not ``tight``,
    every expert takes the largest block count: units whose tiles hold no
    token row."""
    n, T, d, f = 4, 128, 128, 128
    arrs = numpy_inputs(n, T, d, f, f if shared else 0, seed=sum(counts[:2]))
    ts = inputs_from_numpy(*arrs, device=cuda_device)
    sh = (ts[0], ts[3], ts[4]) if shared else None
    kw = dict(counts=counts, block_tokens=64, tight=tight,
              **GPU_VARIANTS[variant])
    grid, _ = kern.grid_for(cuda_device, n, shared, kw.get("wire_i8", False))
    ctas = kern.rank_ctas(grid, kern.make_schedule(counts, tight=tight), f,
                          (T, f) if shared else None,
                          kw.get("tile_fused", False))
    assert min(r for r, _ in ctas) >= 1 and sum(map(sum, ctas)) == grid
    got = kern.moe_dispatch_combine(*ts[:3], shared=sh, **kw)
    want = kern.moe_dispatch_combine_ref(
        *ts[:3], counts=counts, block_tokens=64, tight=tight,
        wire_i8=kw.get("wire_i8", False), shared=sh)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = 1e-3 if kw.get("wire_i8") else 1e-4
    for g, w in zip(got, want):
        assert rel_err(g.cpu(), w.cpu()) <= tol


@pytest.mark.gpu
def test_launch_after_launch_sees_fresh_flags(cuda_device):
    """Back-to-back launches of every variant on one stream, reusing the
    allocator's freed flag and counter words: each launch waits on its
    own arrivals and H counts, never a stale count from the one before."""
    n, T, d, f = 4, 256, 128, 128
    arrs = numpy_inputs(n, T, d, f, f, seed=11)
    ts = inputs_from_numpy(*arrs, device=cuda_device)
    sh = (ts[0], ts[3], ts[4])
    counts = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f, skew=3.0)._counts(T)
    outs = [(kw, kern.moe_dispatch_combine(*ts[:3], counts=counts, shared=sh,
                                           **kw))
            for _ in range(3) for kw in GPU_VARIANTS.values()]
    torch.cuda.synchronize()
    for kw, got in outs:
        want = kern.moe_dispatch_combine_ref(
            *ts[:3], counts=counts, wire_i8=kw.get("wire_i8", False),
            shared=sh)
        tol = 1e-3 if kw.get("wire_i8") else 1e-4
        for g, w in zip(got, want):
            assert rel_err(g.cpu(), w.cpu()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,swiglu", [(70, 100, 256, True),
                                          (1, 64, 128, True),
                                          (200, 96, 40, False),
                                          (130, 67, 65, False),
                                          (64, 4096, 200, False),
                                          (256, 7168, 4096, True),
                                          (130, 100, 200, False),
                                          (257, 36, 384, True),
                                          (1100, 2052, 260, False)])
def test_gemm_core_matches_matmul(cuda_device, M, K, N, swiglu):
    """The GEMM alone against torch.matmul (f32, no TF32) at ragged rows
    (M off 64: a last tile of 64 or 128 rows), columns and depth (K off
    32: TMA's zero fill), the unaligned path (K, N not multiples of 4:
    tc_gemm.cuh's tile), more tiles than SMs, and serving's GEMM1 shape:
    within 1e-4 (3xTF32 keeps f32 accuracy; the sums run in another
    order)."""
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                         .astype(np.float32))
    a, b = a.to(cuda_device), b.to(cuda_device)
    got = kern.gemm_core(a, b, swiglu=swiglu)
    want = torch.matmul(a, b)
    if swiglu:
        g, u = torch.chunk(want, 2, dim=-1)
        want = torch.nn.functional.silu(g) * u
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["tile_fused", "deferred_signal"])
@pytest.mark.parametrize("shape", [(4, 32, 32, 64, 0), (4, 96, 100, 72, 40)])
def test_kernel_pads_unaligned_widths(cuda_device, variant, shape):
    """d, f or fs off the tile GEMM's 64 (the verify suite's moe point is
    d 32, f 64): the entry pads them with zeros and cuts the output back,
    within 1e-4 of the plain version on the operands as given."""
    n, T, d, f, fs = shape
    ts = inputs_from_numpy(*numpy_inputs(n, T, d, f, fs, seed=d + f),
                           device=cuda_device)
    shared = (ts[0], ts[3], ts[4]) if fs else None
    counts = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)._counts(T)
    kw = dict(counts=counts, block_tokens=16, **kern.VARIANTS[variant])
    got = kern.moe_dispatch_combine(*ts[:3], shared=shared, **kw)
    want = kern.moe_dispatch_combine_ref(*ts[:3], counts=counts,
                                         block_tokens=16, shared=shared)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g.cpu(), w.cpu()) <= 1e-4


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros((4, 64, 100), device=cuda_device)
    w1 = torch.zeros((4, 100, 128), device=cuda_device)
    w2 = torch.zeros((4, 64, 100), device=cuda_device)
    # the entry pads d = 100 to the tile (test_kernel_pads_unaligned_widths);
    # the launch itself takes multiples of it only
    with pytest.raises(ValueError, match="multiples"):
        kern.moe_dispatch_logged(x, w1, w2, counts=[16] * 4)
    with pytest.raises(ValueError, match="float32"):
        kern.moe_dispatch_combine(x.double(), w1, w2, counts=[16] * 4)


# ----------------------------------------- the figures' kernel points
# (``repro_torch.figures``): each kernelized point of fig3-6 and table5 at
# a mid shape, through its workload's build on the card, against the same
# build on CPU copies of the inputs (where each wrapper computes its plain
# version): ring hd 32 and 64, kv dk 1024, moe n 8 and block_tokens 128
def _figure_points():
    from repro_torch.figures import (fig3_flash_attention, fig4_moe_skew,
                                     fig5_kv_transfer, fig6_gemm_allgather,
                                     table5_moe_phases)
    f4 = fig4_moe_skew.points()
    f4k = [k for k in fig4_moe_skew.POINT_NAMES if k.startswith(("deepep",
                                                                  "flux"))]
    t5 = table5_moe_phases.points()
    cases = []
    for n, T in ((8, 512), (2, 1024)):
        kw = dict(n_dev=n, tokens_per_rank=T, d=1024, f=256, skew=5.0)
        cases += [(f"fig4_n{n}_{k}", "moe_dispatch", kw, f4[k]) for k in f4k]
    kw = dict(n_dev=2, tokens_per_rank=1536, d=1024, f=512, skew=2.0)
    cases += [(f"table5_{k}", "moe_dispatch", kw, t5[k])
              for k in ("deepep_kernel_total_ms", "flux_kernel_total_ms")]
    cases.append(("fig5_dk1024_cuco", "kv_transfer",
                  dict(T=2048, d=1024, dk=1024),
                  dict(fig5_kv_transfer.POINTS)["cuco"]))
    cases += [(f"fig6_{k}", "gemm_allgather",
               dict(n_dev=4, M=2048, K=1024, N=1024), d)
              for k, d in fig6_gemm_allgather.POINTS if k in ("deferred",
                                                              "flux")]
    for hd in (32, 64):
        cases += [(f"fig3_hd{hd}_{k}", "ring_attention",
                   dict(n_dev=4, BH=8, seq=2048, hd=hd), d)
                  for k, d in fig3_flash_attention.POINTS
                  if k in ("deferred", "flux")]
    return cases


FIGURE_POINTS = _figure_points()


@pytest.mark.gpu
@pytest.mark.parametrize("case", FIGURE_POINTS, ids=[c[0] for c in
                                                     FIGURE_POINTS])
def test_figure_kernel_points_match_plain_version(cuda_device, case):
    """One launch of the point's kernel, within 1e-4 of the plain version
    (1e-3 on the int8 wire), max-abs-normalised."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.figures import common
    from repro_torch.workloads import get_workload
    _, wname, kw, d = case
    w = get_workload(wname, **kw)
    ins = common.inputs(w, cuda_device, seed=1)
    kmod = common.kernel_module(wname)
    before = kmod.launches()
    with torch.no_grad():
        got = w.build(d, VirtualMesh(w.n_dev, device=cuda_device))(*ins)
        want = w.build(d, VirtualMesh(w.n_dev, device="cpu"))(
            *(t.cpu() for t in ins))
    torch.cuda.synchronize()
    assert kmod.launches() == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = 1e-3 if d.tunable("wire_i8", 0) else 1e-4
    for g, wt in zip(got, want):
        assert g.shape == wt.shape and rel_err(g.cpu(), wt) <= tol
