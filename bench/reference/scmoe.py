"""Plain PyTorch reference of LongCat-Flash's shortcut-connected MoE
(ScMoE) double-layer, attention left out, the benchmark's copy of the
port's ``models/longcat_ref.py``: float32 with TF32 off ("float32"), or
its products at TF32 for the control ("tf32").

For a double-layer with input h (..., d):

- u = RMSNorm0(h); scores = softmax(u Wr) over the E FFN and Z zero
  experts, in float32;
- the k picks are the top-k of scores + b; each pick's gate is g = scale
  * score, with no renormalisation;
- m = sum over the picks, in pick order, of g * SwiGLU_j(u) for an FFN
  expert j < E and of g * u for a zero (identity) expert;
- h1 = h + FFN1(u); out = h1 + FFN2(RMSNorm1(h1)) + m.

Expert j's weights are ``w1[j % held]`` / ``w2[j % held]``. A pick near a
tie can flip between two float32 computations, so the layer is computed
with the program's picks, and :func:`route_gap` says how far each lies
below the reference's own k-th score.
"""
from __future__ import annotations

import torch

from bench.reference.common import mm, precision

LAYER_KEYS = ("wr", "b", "w1", "w2", "s1", "s2", "t1", "t2", "g0", "g1")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, w1, w2, mode):
    """GEMM1 (gate | up, 2f) -> silu(gate) * up -> GEMM2."""
    g, u = mm(x, w1, mode).chunk(2, dim=-1)
    return mm(g * torch.sigmoid(g) * u, w2, mode)


def route_gap(s, b, picks):
    """The largest amount by which a picked expert's score + b falls below
    the k-th largest score + b: 0 where the picks are the top k."""
    v = s + b
    kth = torch.topk(v, picks.shape[-1], dim=-1).values[..., -1:]
    return float((kth - v.gather(-1, picks)).clamp_min(0).max())


def ffn_rows(picks, n_experts):
    """Rows a layer's FFN experts compute: its picks of an FFN expert."""
    return int((picks < n_experts).sum())


def double_layer(h, layer, picks=None, *, n_experts, topk, scale, eps,
                 mode="float32"):
    """One double-layer of h (..., d) with ``layer`` (:data:`LAYER_KEYS`);
    ``picks`` (..., topk) the program's, or None for the reference's own.
    Returns ``(out, picks, route_gap)``."""
    with precision(h.device, mode):
        u = rms_norm(h, layer["g0"], eps)
        s = torch.softmax(mm(u, layer["wr"], mode), dim=-1)
        if picks is None:
            picks = torch.topk(s + layer["b"], topk, dim=-1).indices
        gap = route_gap(s, layer["b"], picks)
        w1, w2 = layer["w1"], layer["w2"]
        held = w1.shape[0]
        vals = u.unsqueeze(-2).expand(*picks.shape, u.shape[-1]).clone()
        for e in range(held):
            sel = (picks < n_experts) & (picks % held == e)
            if sel.any():       # the rows still hold u
                vals[sel] = swiglu(vals[sel], w1[e], w2[e], mode)
        g = scale * s.gather(-1, picks)
        m = torch.zeros_like(u)
        for i in range(picks.shape[-1]):
            m = m + g[..., i:i + 1] * vals[..., i, :]
        h1 = h + swiglu(u, layer["s1"], layer["s2"], mode)
        out = h1 + swiglu(rms_norm(h1, layer["g1"], eps), layer["t1"],
                          layer["t2"], mode) + m
    return out, picks, gap


def forward(h, layers, picks=None, **cfg):
    """The double-layers in turn, ``picks`` one a layer (or None): ``(out,
    picks of each layer, the largest route_gap)``."""
    got, worst = [], 0.0
    for i, layer in enumerate(layers):
        h, p, gap = double_layer(h, layer, None if picks is None
                                 else picks[i], **cfg)
        got.append(p)
        worst = max(worst, gap)
    return h, got, worst
