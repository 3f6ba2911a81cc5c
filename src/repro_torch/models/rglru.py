"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; port
of ``repro/models/rglru.py``).

Block structure (Griffin recurrent block):
  x -> norm -> [branch A: linear -> causal conv1d(w=4) -> RG-LRU]
            -> [branch B: linear -> gelu]
  y = out_proj(A * B) + x

RG-LRU: r_t = sigma(W_r u_t), i_t = sigma(W_i u_t),
        log a_t = -c * softplus(L) * r_t        (c = 8)
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

``lam``, ``h`` and the gates stay in float32, as the reference keeps them.
Prefill runs the recurrence as a log-depth (Hillis-Steele) scan over the
sequence where the reference runs ``jax.lax.associative_scan``: the same
combine, summed in another order. Decode is one step. Decode state: ``h``
and the conv tail of the last ``conv_width - 1`` inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_norm, dense_init, draw, norm_init

F32 = torch.float32
_C = 8.0


def rglru_init(gen, cfg, dtype, device):
    d = cfg.d_model
    # Lambda init so a^(1/c) ~ U[0.9, 0.999] (griffin appendix)
    u = draw(gen, (d,), uniform=True) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u)))          # softplus^-1(-log u)
    conv_w = draw(gen, (cfg.conv_width, d)) / math.sqrt(cfg.conv_width)
    return {
        "norm": norm_init(d, cfg.norm, dtype, device),
        "in_a": dense_init(gen, d, d, dtype, device=device),
        "in_b": dense_init(gen, d, d, dtype, device=device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((d,), dtype=dtype, device=device),
        "wr": dense_init(gen, d, d, dtype, device=device),
        "wi": dense_init(gen, d, d, dtype, device=device),
        "lam": lam.to(device),
        "out": dense_init(gen, d, d, dtype, device=device),
    }


def rglru_state_shape(cfg, B):
    d = cfg.d_model
    return {"h": (B, d), "conv": (B, cfg.conv_width - 1, d)}


def rglru_init_state(cfg, B, dtype=F32, device=None):
    sh = rglru_state_shape(cfg, B)
    return {"h": torch.zeros(sh["h"], dtype=F32, device=device),
            "conv": torch.zeros(sh["conv"], dtype=dtype, device=device)}


def _causal_conv(u, w, b, tail):
    """u: (B,S,d); w: (K,d) depthwise. tail: (B,K-1,d) history."""
    K, S = w.shape[0], u.shape[1]
    upad = torch.cat([tail.to(u.dtype), u], dim=1)            # (B,S+K-1,d)
    out = upad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + upad[:, i:i + S] * w[i]
    new_tail = upad[:, -(K - 1):].clone() if K > 1 else tail
    return out + b, new_tail


def _rglru_scan(a_log, x_in, h0):
    """Elementwise linear recurrence h_t = exp(a_log_t) h_{t-1} + x_in_t over
    axis 1, as a log-depth scan of the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 + a2, exp(a2) b1 + b2)``.

    a_log: (B,S,d) log decay; x_in: (B,S,d) input term; h0: (B,d)."""
    b = x_in.clone()
    b[:, 0] = b[:, 0] + torch.exp(a_log[:, 0]) * h0          # fold h0 in
    a = a_log
    off, S = 1, a_log.shape[1]
    while off < S:
        b = torch.cat([b[:, :off],
                       torch.exp(a[:, off:]) * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] + a[:, off:]], 1)
        off *= 2
    return b


def rglru_apply(p, x, cfg, state=None, decode=False):
    B, S, d = x.shape
    xn = apply_norm(p["norm"], x, cfg.norm)
    ua = xn @ p["in_a"]
    ub = F.gelu(xn @ p["in_b"], approximate="tanh")           # jax.nn.gelu
    if state is None:
        state = rglru_init_state(cfg, B, device=x.device)
    u, new_tail = _causal_conv(ua, p["conv_w"], p["conv_b"], state["conv"])
    uf = u.to(F32)
    r = torch.sigmoid((u @ p["wr"]).to(F32))
    i = torch.sigmoid((u @ p["wi"]).to(F32))
    log_a = -_C * F.softplus(p["lam"].to(F32)) * r            # (B,S,d)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * uf)
    if decode:
        assert S == 1
        h = torch.exp(log_a[:, 0]) * state["h"] + gated[:, 0]
        hs, new_h = h[:, None], h
    else:
        hs = _rglru_scan(log_a, gated, state["h"])
        new_h = hs[:, -1].clone()
    y = (hs.to(x.dtype) * ub) @ p["out"]
    return x + y, {"h": new_h, "conv": new_tail}
