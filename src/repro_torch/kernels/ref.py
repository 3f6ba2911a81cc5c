"""Plain-torch oracles for every kernel of the JAX package (port of
``repro/kernels/ref.py``), in its layouts."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal=True):
    """q/k/v: (BH, S, hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        Sq, Skv = s.shape[-2:]
        mask = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Skv, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def ring_attention_ref(q, k, v, *, causal=True):
    """Global oracle for ring attention: q/k/v (n_dev, BH, S_l, hd) stacked
    per device -> same layout output. Equivalent to full attention over the
    concatenated sequence."""
    n, BH, Sl, hd = q.shape

    def flat(t):
        return t.permute(1, 0, 2, 3).reshape(BH, n * Sl, hd)

    o = flash_attention_ref(flat(q), flat(k), flat(v), causal=causal)
    return o.reshape(BH, n, Sl, hd).permute(1, 0, 2, 3)


def gemm_allgather_ref(a_shards, b):
    """a_shards: (n_dev, M_l, K); b: (K, N) -> (n_dev, n_dev*M_l, N):
    every device ends with the full concatenated GEMM output."""
    c = torch.einsum("nmk,kp->nmp", a_shards, b)
    full = c.reshape(-1, b.shape[1])
    n = a_shards.shape[0]
    return full[None].expand((n,) + tuple(full.shape))


def kv_shuttle_ref(x, wk, wv):
    """Prefill rank computes K = x@wk, V = x@wv; decode rank receives both."""
    return x @ wk, x @ wv
