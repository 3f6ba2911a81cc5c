"""Plain PyTorch reference of LongCat-Flash's shortcut-connected MoE
(ScMoE) double-layer, attention left out: float32 with TF32 off, no
kernels, cache or batching. It imports nothing of the port, which the
tests hold to it (``workloads/scmoe.py::ScMoEStep``).

For a double-layer with input h (..., d), as LongCat-Flash's modeling
code runs it with both attention modules and their residual adds taken
out:

- u = RMSNorm0(h);
- scores = softmax(u Wr) over the E FFN experts and Z zero experts, in
  float32;
- the k picks are the top-k of scores + b (b: ``e_score_correction_bias``);
- each pick's gate is g = scale * score, with no renormalisation;
- m = sum over the picks, in pick order, of g * SwiGLU_j(u) for an FFN
  expert j < E and of g * u for a zero (identity) expert;
- h1 = h + FFN1(u);
- out = h1 + FFN2(RMSNorm1(h1)) + m.

The MoE takes the input of the first dense FFN and is added only at the
end, which is what lets a program run its dispatch beside FFN1.

Expert j's weights are ``w1[j % held]`` / ``w2[j % held]``: ``held``
tensors stand for all E (a chip's share of an expert-parallel
deployment, every pick still computed); ``held == E`` is the uncut
layer. A reading of picks near a tie can flip between two float32
computations, so :func:`double_layer` takes a program's picks, and
:func:`route_gap` says how far each lies from the reference's own.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LAYER_KEYS = ("wr", "b", "w1", "w2", "s1", "s2", "t1", "t2", "g0", "g1")


@contextlib.contextmanager
def float32(device):
    """TF32 off on the card over the block, the switches put back after."""
    if torch.device(device).type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, w1, w2):
    """w1 (d, 2f): gate | up; w2 (f, d)."""
    g, u = (x @ w1).chunk(2, dim=-1)
    return (F.silu(g) * u) @ w2


def scores(u, wr):
    return torch.softmax(u @ wr, dim=-1)


def route(s, b, topk):
    """The top-k of scores + bias, in descending order."""
    return torch.topk(s + b, topk, dim=-1).indices


def route_gap(s, b, picks):
    """The largest amount by which a picked expert's score + b falls below
    the k-th largest score + b: 0 where the picks are the top k."""
    v = s + b
    kth = torch.topk(v, picks.shape[-1], dim=-1).values[..., -1:]
    return float((kth - v.gather(-1, picks)).clamp_min(0).max())


def moe(u, s, picks, w1, w2, *, n_experts, scale):
    """m: each pick's expert output (the identity for a zero expert)
    times its gate, summed in pick order."""
    held = w1.shape[0]
    vals = u.unsqueeze(-2).expand(*picks.shape, u.shape[-1]).clone()
    for e in range(held):
        sel = (picks < n_experts) & (picks % held == e)
        if sel.any():       # the rows still hold u
            vals[sel] = swiglu(vals[sel], w1[e], w2[e])
    g = scale * s.gather(-1, picks)
    m = torch.zeros_like(u)
    for i in range(picks.shape[-1]):
        m = m + g[..., i:i + 1] * vals[..., i, :]
    return m


def double_layer(h, layer, picks=None, *, n_experts, topk, scale, eps):
    """One double-layer of h (..., d) with ``layer`` (:data:`LAYER_KEYS`:
    wr (d, E + Z), b (E + Z), w1 (held, d, 2f), w2 (held, f, d), s1 / t1
    (d, 2 fd), s2 / t2 (fd, d), g0 / g1 (d)); ``picks`` (..., topk) a
    program's, or None for the reference's own. Returns ``(out, picks,
    route_gap)``."""
    with float32(h.device):
        u = rms_norm(h, layer["g0"], eps)
        s = scores(u, layer["wr"])
        if picks is None:
            picks = route(s, layer["b"], topk)
        gap = route_gap(s, layer["b"], picks)
        m = moe(u, s, picks, layer["w1"], layer["w2"], n_experts=n_experts,
                scale=scale)
        h1 = h + swiglu(u, layer["s1"], layer["s2"])
        out = h1 + swiglu(rms_norm(h1, layer["g1"], eps), layer["t1"],
                          layer["t2"]) + m
    return out, picks, gap


def forward(h, layers, picks=None, **cfg):
    """The double-layers in turn; ``picks`` one a layer (or None). Returns
    ``(out, picks of each layer, the largest route_gap)``."""
    got, worst = [], 0.0
    for i, layer in enumerate(layers):
        h, p, gap = double_layer(h, layer, None if picks is None
                                 else picks[i], **cfg)
        got.append(p)
        worst = max(worst, gap)
    return h, got, worst
