"""Public wrappers for the port's attention and collective kernels (port of
``repro/kernels/ops.py``), as plain functions on tensors.

The reference wraps each Pallas kernel in ``jax.jit`` and takes an
``interpret`` flag. Neither has a counterpart here: PyTorch runs eagerly,
so there is nothing to trace or cache, and a kernel's device is its
tensors' — a CUDA tensor launches the Hopper kernel (or raises), a CPU
tensor runs the kernel's plain version. The layouts are the reference's:
q/k/v ``(BH, S, hd)`` for flash attention, stacked ``(n, ...)`` ranks for
the others.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.gemm_allgather import gemm_allgather as _ga
from repro_torch.kernels.kv_shuttle import kv_shuttle as _kv
from repro_torch.kernels.ring_attention import ring_attention as _ring


def flash_attention(q, k, v, *, causal=True, q_block=128, kv_block=128):
    return _fa(q, k, v, causal=causal, q_block=q_block, kv_block=kv_block)


def ring_attention(q, k, v, mesh, *, axis="x", causal=True, pipelined=True,
                   eager_wait=False, fused=False, counter=False,
                   kv_chunk=None, contexts=2):
    return _ring(q, k, v, mesh, axis=axis, causal=causal,
                 pipelined=pipelined, eager_wait=eager_wait, fused=fused,
                 counter=counter, kv_chunk=kv_chunk, contexts=contexts)


def gemm_allgather(a_shards, b, mesh, *, axis="x", tile_m=128, fused=True,
                   counter=False, contexts=2):
    return _ga(a_shards, b, mesh, axis=axis, tile_m=tile_m, fused=fused,
               counter=counter, contexts=contexts)


def kv_shuttle(x, wk, wv, mesh, *, axis="x", chained=True, fused=False,
               counter=False, kv_chunk=None, contexts=2):
    """The reference's layout and signature: x (2, T, d), the mesh of the
    two ranks (only its size is checked)."""
    del axis
    if mesh is not None and mesh.n != x.shape[0]:
        raise ValueError(f"a mesh of {mesh.n} ranks cannot take "
                         f"{x.shape[0]} shards")
    return _kv(x, wk, wv, chained=chained, fused=fused, counter=counter,
               kv_chunk=kv_chunk, contexts=contexts)
