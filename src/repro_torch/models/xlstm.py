"""xLSTM blocks (arXiv:2405.04517; port of ``repro/models/xlstm.py``): mLSTM
(matrix memory, chunkwise-parallel) and sLSTM (scalar memory, sequential
cell with recurrent gate connections).

mLSTM is a gated linear recurrence C_t = f_t C_{t-1} + i_t k_t v_t^T with
exponential input gating and a max-stabiliser m. Prefill takes the
reference's chunkwise-parallel form (intra-chunk quadratic, inter-chunk
state carry) with its chunk ``W = min(cfg.mlstm_chunk, S)``, its
state-preserving pad (``i = -1e30``, ``log_f = 0``) and its stabiliser, so
the sums run in the reference's order; the loop over chunks stands where
the reference scans. sLSTM is the same cell, looped over the tokens.
Decode is one recurrent step of either. States are float32: mLSTM ``C``
(B,H,dh,dh), ``n`` (B,H,dh), ``m`` (B,H) starting at -1e30; sLSTM ``c``,
``n``, ``h``, ``m`` (B,d).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_norm, dense_init, draw, norm_init

F32 = torch.float32
M_INIT = -1e30


# ------------------------------------------------------------------- mLSTM

def mlstm_init(gen, cfg, dtype, device):
    d = cfg.d_model
    du = 2 * d
    H = cfg.num_heads

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, dtype, scale=scale, device=device)

    return {
        "norm": norm_init(d, cfg.norm, dtype, device),
        "up": dense(d, 2 * du),                               # -> (u, z-gate)
        "q": dense(du, du),
        "k": dense(du, du),
        "v": dense(du, du),
        "wi": dense(du, H, scale=0.01),
        "wf": dense(du, H, scale=0.01),
        "bf": torch.full((H,), 3.0, dtype=dtype, device=device),  # forget bias
        "bi": torch.zeros((H,), dtype=dtype, device=device),
        "hnorm": norm_init(du, "rmsnorm", dtype, device),     # per-head norm
        "down": dense(du, d),
    }


def _log_sigmoid(x):
    """log sigmoid(x) = -log(1 + exp(-x)), the reference's
    ``jax.nn.log_sigmoid`` (-softplus(-x)), as one softplus of beta -1
    (linear, so x, past -20). ``F.logsigmoid`` agrees to an ulp, but its
    forward keeps a buffer of the input's size on the host and on meta
    and none on CUDA, so a meta count of the step would not be the
    card's."""
    return F.softplus(x, beta=-1.0)


def _mlstm_gates(u, p):
    i_raw = (u @ p["wi"]).to(F32) + p["bi"].to(F32)          # (B,S,H)
    f_raw = (u @ p["wf"]).to(F32) + p["bf"].to(F32)
    return i_raw, _log_sigmoid(f_raw)


def _mlstm_qkv(u, p, H):
    B, S, du = u.shape
    dh = du // H
    q = (u @ p["q"]).reshape(B, S, H, dh)
    k = (u @ p["k"]).reshape(B, S, H, dh)
    v = (u @ p["v"]).reshape(B, S, H, dh)
    return q, k, v, dh


def mlstm_state_shape(cfg, B):
    du = 2 * cfg.d_model
    H = cfg.num_heads
    dh = du // H
    return {"C": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)}


def mlstm_init_state(cfg, B, device=None):
    sh = mlstm_state_shape(cfg, B)
    return {"C": torch.zeros(sh["C"], dtype=F32, device=device),
            "n": torch.zeros(sh["n"], dtype=F32, device=device),
            "m": torch.full(sh["m"], M_INIT, dtype=F32, device=device)}


def _mlstm_chunk_scan(q, k, v, i_raw, log_f, state, W):
    """Chunkwise-parallel mLSTM. q/k/v: (B,S,H,dh); gates (B,S,H); S a
    multiple of W."""
    B, S, H, dh = q.shape
    nC = S // W
    scale = 1.0 / math.sqrt(dh)
    qc = q.reshape(B, nC, W, H, dh).to(F32) * scale
    kc = k.reshape(B, nC, W, H, dh).to(F32)
    vc = v.reshape(B, nC, W, H, dh).to(F32)
    ic = i_raw.reshape(B, nC, W, H)
    lfc = log_f.reshape(B, nC, W, H)
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    Cb, nb, m0 = state["C"], state["n"], state["m"]
    hs = []
    # each chunk's slices taken once: their backward is one stack, where a
    # select per chunk would write and sum nC zeroed inputs' worth
    for qb, kb, vb, ib, lfb in zip(*(t.unbind(1)
                                     for t in (qc, kc, vc, ic, lfc))):
        Bt = torch.cumsum(lfb, dim=1)                         # (B,W,H)
        # intra-chunk log weights: D[t,s] = Bt[t]-Bt[s]+i[s], s<=t
        Dts = Bt[:, :, None, :] - Bt[:, None, :, :] + ib[:, None, :, :]
        Dts = Dts.masked_fill(~tri[None, :, :, None], -math.inf)
        m_intra = torch.amax(Dts, dim=2)                      # (B,W,H)
        m_t = torch.maximum(m0[:, None] + Bt, m_intra)        # (B,W,H)
        w_inter = torch.exp(m0[:, None] + Bt - m_t)           # (B,W,H)
        num_inter = torch.einsum("bwhd,bhde->bwhe", qb, Cb) \
            * w_inter[..., None]
        den_inter = torch.einsum("bwhd,bhd->bwh", qb, nb) * w_inter
        P = torch.exp(Dts - m_t[:, :, None, :])               # (B,W,W,H)
        A = torch.einsum("bwhd,bshd->bwsh", qb, kb) * P
        num = num_inter + torch.einsum("bwsh,bshe->bwhe", A, vb)
        den = den_inter + torch.sum(A, dim=2)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        # carry to the next chunk
        BW = Bt[:, -1]                                        # (B,H)
        wk = BW[:, None] - Bt + ib                            # (B,W,H)
        m_next = torch.maximum(m0 + BW, torch.amax(wk, dim=1))
        wk = torch.exp(wk - m_next[:, None])
        decay = torch.exp(m0 + BW - m_next)
        Cb = decay[..., None, None] * Cb + torch.einsum(
            "bwhd,bwhe->bhde", wk[..., None] * kb, vb)
        nb = decay[..., None] * nb + torch.einsum("bwh,bwhd->bhd", wk, kb)
        m0 = m_next
    h = torch.stack(hs, dim=1).reshape(B, S, H, dh)
    return h, {"C": Cb, "n": nb, "m": m0}


def mlstm_apply(p, x, cfg, state=None, decode=False):
    """x: (B,S,d). Returns (y, new_state)."""
    B, S, d = x.shape
    H = cfg.num_heads
    xn = apply_norm(p["norm"], x, cfg.norm)
    u, z = torch.chunk(xn @ p["up"], 2, dim=-1)               # (B,S,2d) each
    q, k, v, dh = _mlstm_qkv(u, p, H)
    i_raw, log_f = _mlstm_gates(u, p)
    if state is None:
        state = mlstm_init_state(cfg, B, device=x.device)
    if decode:
        assert S == 1
        qs, ks, vs = (t[:, 0].to(F32) for t in (q, k, v))
        ib, lfb = i_raw[:, 0], log_f[:, 0]
        m_new = torch.maximum(lfb + state["m"], ib)
        fp = torch.exp(lfb + state["m"] - m_new)
        ip = torch.exp(ib - m_new)
        C = fp[..., None, None] * state["C"] + ip[..., None, None] \
            * torch.einsum("bhd,bhe->bhde", ks, vs)
        n = fp[..., None] * state["n"] + ip[..., None] * ks
        qs = qs / math.sqrt(dh)
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.einsum("bhd,bhd->bh", qs, n)
        h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
        h = h[:, None]                                        # (B,1,H,dh)
        new_state = {"C": C, "n": n, "m": m_new}
    else:
        W = min(cfg.mlstm_chunk, S)
        pad = (-S) % W
        if pad:
            # state-preserving pad: i = -1e30 (no input), log_f = 0 (no decay)
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            i_raw = F.pad(i_raw, (0, 0, 0, pad), value=M_INIT)
            log_f = F.pad(log_f, (0, 0, 0, pad))
        h, new_state = _mlstm_chunk_scan(q, k, v, i_raw, log_f, state, W)
        h = h[:, :S]
    hflat = h.reshape(B, S, H * dh).to(x.dtype)
    hflat = apply_norm(p["hnorm"], hflat, "rmsnorm")
    return x + (hflat * F.silu(z)) @ p["down"], new_state


# -------------------------------------------------------------------- sLSTM

def slstm_init(gen, cfg, dtype, device):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    ff = -(-int(4 * d / 3) // 16) * 16            # shard-friendly multiple of 16
    r = draw(gen, (H, dh, 4 * dh)) / math.sqrt(dh)

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, dtype, device=device)

    return {
        "norm": norm_init(d, cfg.norm, dtype, device),
        "w": dense(d, 4 * d),                                 # i,f,z,o
        "r": r.to(device=device, dtype=dtype),                # block-diagonal
        "b": torch.cat([torch.zeros((d,)), torch.full((d,), 3.0),  # forget
                        torch.zeros((2 * d,))]).to(device=device, dtype=dtype),
        "ffn_norm": norm_init(d, cfg.norm, dtype, device),
        "ff_gate": dense(d, ff),
        "ff_up": dense(d, ff),
        "ff_down": dense(ff, d),
    }


def slstm_state_shape(cfg, B):
    d = cfg.d_model
    return {"c": (B, d), "n": (B, d), "h": (B, d), "m": (B, d)}


def slstm_init_state(cfg, B, device=None):
    return {k: torch.full(v, M_INIT if k == "m" else 0.0, dtype=F32,
                          device=device)
            for k, v in slstm_state_shape(cfg, B).items()}


def _slstm_cell(state, wx_t, r, H):
    """One step. wx_t: (B, 4d) precomputed Wx+b; state dict of (B,d); r the
    recurrent weights in float32."""
    B, d4 = wx_t.shape
    d = d4 // 4
    h_prev = state["h"].reshape(B, H, d // H)
    rec = torch.einsum("bhd,hde->bhe", h_prev, r).reshape(B, 4 * d)
    i_raw, f_raw, z_raw, o_raw = torch.chunk(wx_t + rec, 4, dim=-1)
    log_f = _log_sigmoid(f_raw)
    m_new = torch.maximum(log_f + state["m"], i_raw)
    ip = torch.exp(i_raw - m_new)
    fp = torch.exp(log_f + state["m"] - m_new)
    c = fp * state["c"] + ip * torch.tanh(z_raw)
    n = fp * state["n"] + ip
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_apply(p, x, cfg, state=None, decode=False):
    B, S, d = x.shape
    H = cfg.num_heads
    xn = apply_norm(p["norm"], x, cfg.norm)
    wx = (xn @ p["w"]).to(F32) + p["b"].to(F32)               # (B,S,4d)
    if state is None:
        state = slstm_init_state(cfg, B, device=x.device)
    r = p["r"].to(F32)
    if decode:
        assert S == 1
    hs = []
    for wx_t in wx.unbind(1):          # one stack in the backward, as above
        state = _slstm_cell(state, wx_t, r, H)
        hs.append(state["h"])
    y = x + torch.stack(hs, dim=1).to(x.dtype)                 # (B,S,d)
    # post up-projection gated FFN
    yn = apply_norm(p["ffn_norm"], y, cfg.norm)
    ff = F.gelu(yn @ p["ff_gate"], approximate="tanh") * (yn @ p["ff_up"])
    return y + ff @ p["ff_down"], state
