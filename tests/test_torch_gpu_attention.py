"""The Hopper flash_attention and ring_attention kernels against their
plain versions, on the card.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port, so it runs on the
card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_attention.py

Inputs are made with numpy from a seed. Tolerances: 1e-4 max-abs-normalised
in f32 (the kernels sum in another order, and take exp on the special
function unit); for bf16 flash and ring attention each element within
one bf16 step of the plain version's plus 1e-4 (both round an f32 result
to bf16, so a right kernel is at most one rounding step off; a step is at
most 2^-7 of the value).
"""
import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ring_attention as ra
from torch_port_helpers import rel_err


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def bf16_steps(got, want):
    """Largest |got - want| / (2^-7 |want| + 1e-4) over the elements: at
    most 1 when every element is within one bf16 step (plus 1e-4)."""
    got, want = got.float().cpu(), want.float().cpu()
    assert bool(torch.isfinite(got).all())
    return float(((got - want).abs() / (2.0 ** -7 * want.abs() + 1e-4)).max())


def _qkv(shape, device, seed, kv_rows=None):
    rng = np.random.default_rng(seed)
    kv_shape = shape if kv_rows is None else shape[:-2] + (kv_rows,
                                                          shape[-1])
    arrs = [rng.standard_normal(shape), rng.standard_normal(kv_shape),
            rng.standard_normal(kv_shape)]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


# ------------------------------------------------------------------ flash


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,blocks", [
    ((2, 256, 256, 64), (128, 128)), ((3, 200, 200, 32), (8, 8)),
    ((2, 192, 192, 80), (64, 64)), ((1, 128, 128, 128), (64, 128)),
    ((2, 96, 96, 13), (32, 32)), ((2, 128, 256, 64), (64, 64)),
    ((2, 100, 180, 32), (4, 4)), ((2, 150, 90, 80), (2, 2)),
    ((1, 200, 120, 128), (8, 8)), ((8, 4096, 4096, 64), (128, 128))])
def test_flash_matches_plain_version(cuda_device, shape, blocks, causal,
                                     dtype):
    """Ragged query and key tiles, head dims 13 to 128 (synchronous
    loads for 13), more keys than queries and fewer (S and Skv off the
    64-row tile at hd 32, 80 and 128), f32 and bf16, and the ring's whole
    sequence at RingAttention's defaults."""
    BH, S, Skv, hd = shape
    q, k, v = (t.to(dtype) for t in _qkv((BH, S, hd), cuda_device,
                                          seed=sum(shape), kv_rows=Skv))
    qb, kb = blocks
    before = fa.launches()
    got = fa.flash_attention(q, k, v, causal=causal, q_block=qb, kv_block=kb)
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_block=qb,
                                    kv_block=kb)
    torch.cuda.synchronize()
    assert fa.launches() == before + 1
    assert got.dtype == dtype and got.shape == (BH, S, hd)
    if dtype == torch.bfloat16:
        assert bf16_steps(got, want) <= 1.0
    else:
        assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
def test_flash_large_logits_stay_finite(cuda_device):
    q = 30.0 * _qkv((1, 128, 64), cuda_device, seed=3)[0]
    got = ops.flash_attention(q, q, q, causal=True)
    want = fa.flash_attention_plain(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
def test_flash_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros((1, 128, 64), device=cuda_device)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(q[:, :100], q[:, :100], q[:, :100])
    with pytest.raises(ValueError, match="hd <= 128"):
        big = torch.zeros((1, 128, 256), device=cuda_device)
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="must match q"):
        fa.flash_attention(q, q.bfloat16(), q)


# ------------------------------------------------------------------- ring

GPU_RING_VARIANTS = dict(ra.VARIANTS, **{
    "fused_signal_kc100": dict(fused=True, counter=False, kv_chunk=100),
    "fused_counter_kc256": dict(fused=True, counter=True, kv_chunk=256),
    "pipelined_contexts1": dict(pipelined=True, contexts=1),
})


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GPU_RING_VARIANTS))
@pytest.mark.parametrize("shape", [(4, 2, 256, 64), (4, 3, 200, 32),
                                   (2, 2, 128, 128), (3, 1, 96, 64),
                                   (4, 48, 512, 64), (4, 8, 1024, 64)])
def test_ring_matches_plain_version(cuda_device, variant, shape):
    """Every realization at aligned and ragged shards, head dims 32 to
    128, odd rank counts, and 48 x 8 pieces a rank (more than its CTAs:
    the softmax state parks between steps)."""
    q, k, v = _qkv(shape, cuda_device, seed=sum(shape))
    knobs = GPU_RING_VARIANTS[variant]
    before = ra.launches()
    got = ra.ring_attention(q, k, v, **knobs)
    want = ra.ring_attention_plain(q, k, v, **knobs)
    torch.cuda.synchronize()
    assert ra.launches() == before + 1
    assert got.shape == q.shape
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GPU_RING_VARIANTS))
@pytest.mark.parametrize("shape", [(4, 2, 256, 64), (4, 3, 200, 32),
                                   (2, 2, 128, 128), (4, 48, 512, 64),
                                   (4, 8, 1024, 64)])
def test_ring_bf16_matches_plain_version(cuda_device, variant, shape):
    """The ring in bf16, as the reference runs it in q's dtype: bf16
    buffers and output, f32 math; each element within one bf16 step."""
    q, k, v = (t.bfloat16() for t in _qkv(shape, cuda_device,
                                          seed=sum(shape) + 1))
    knobs = GPU_RING_VARIANTS[variant]
    got = ra.ring_attention(q, k, v, **knobs)
    want = ra.ring_attention_plain(q, k, v, **knobs)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bf16_steps(got, want) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,BH,Sl,hd", [(4, 8, 1024, 64), (3, 2, 200, 128),
                                        (4, 96, 2048, 64)])
def test_ring_launches_its_ctas_by_causal_work(cuda_device, n, BH, Sl, hd,
                                               causal, dtype):
    """Each CTA bumps its rank's credit counter once a step for steps
    0..n-3, so the counters end at each rank's launched CTAs times n - 2:
    the split :func:`ring_ctas` makes by causal work (even without the
    mask), in every rank, and the whole grid."""
    q, k, v = (t.to(dtype) for t in _qkv((n, BH, Sl, hd), cuda_device,
                                         seed=n + Sl))
    grid, _ = ra.grid_for(cuda_device, n, hd, dtype=dtype)
    want = ra.ring_ctas(grid, n, BH, Sl, causal)
    got, done = ra._launch(q, k, v, causal=causal, kv_chunk=None,
                           fused=True, counter=True, pipelined=True,
                           eager_wait=False, contexts=2, stall=None)
    done = done.cpu().tolist()
    assert sum(want) == grid and done == [c * (n - 2) for c in want]
    if causal:
        assert want == sorted(want) and want[-1] > want[0]
    else:
        assert max(want) - min(want) <= 1
    plain = ra.ring_attention_plain(q, k, v, causal=causal, fused=True,
                                    counter=True)
    if dtype == torch.bfloat16:
        assert bf16_steps(got, plain) <= 1.0
    else:
        assert rel_err(got.cpu(), plain.cpu()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(ra.VARIANTS))
def test_ring_without_the_mask(cuda_device, variant):
    q, k, v = _qkv((4, 2, 192, 64), cuda_device, seed=11)
    mesh = VirtualMesh(4, device=cuda_device)
    got = ops.ring_attention(q, k, v, mesh, causal=False,
                             **ra.VARIANTS[variant])
    want = ra.ring_attention_plain(q, k, v, causal=False,
                                   **ra.VARIANTS[variant])
    torch.cuda.synchronize()
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("rank", [0, 1, 3])
@pytest.mark.parametrize("variant", list(ra.VARIANTS))
def test_ring_with_a_slowed_rank(cuda_device, variant, rank):
    """One rank's CTAs idle 3 ms before each step's attention, so its
    upstream rank runs ahead: the free-slot credit must keep it from
    overwriting the slot the slow rank has yet to read. Under the split by
    causal work rank 0 has the fewest CTAs and rank 3 the most."""
    q, k, v = _qkv((4, 4, 256, 64), cuda_device, seed=5 + rank)
    knobs = ra.VARIANTS[variant]
    got = ra.slowed_ring_attention(q, k, v, rank=rank, us=3000, **knobs)
    want = ra.ring_attention_plain(q, k, v, **knobs)
    torch.cuda.synchronize()
    assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
def test_ring_launch_after_launch_sees_fresh_flags(cuda_device):
    q, k, v = _qkv((4, 4, 256, 64), cuda_device, seed=9)
    want = ra.ring_attention_plain(q, k, v)
    outs = [ra.ring_attention(q, k, v, **knobs)
            for _ in range(3) for knobs in GPU_RING_VARIANTS.values()]
    torch.cuda.synchronize()
    for got in outs:
        assert rel_err(got.cpu(), want.cpu()) <= 1e-4


@pytest.mark.gpu
def test_ring_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros((4, 2, 64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ra.ring_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="q's dtype"):
        ra.ring_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="multiple of 8"):
        odd = torch.zeros((4, 2, 64, 36), device=cuda_device).bfloat16()
        ra.ring_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="multiple of 4"):
        odd = torch.zeros((4, 2, 64, 30), device=cuda_device)
        ra.ring_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="hd <= 128"):
        big = torch.zeros((4, 2, 64, 132), device=cuda_device)
        ra.ring_attention(big, big, big)
    with pytest.raises(ValueError, match="alike"):
        ra.ring_attention(q, q[:, :1], q)
    with pytest.raises(ValueError, match="contexts"):
        ra.ring_attention(q, q, q, contexts=0)
    with pytest.raises(ValueError, match="mesh of 2"):
        ra.ring_attention(q, q, q, VirtualMesh(2, device=cuda_device))
