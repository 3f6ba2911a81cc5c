"""Core NN layers shared by the attention architectures (port of
``repro/models/layers.py``).

Plain torch: the JAX package leaves these to XLA (no Pallas kernel), so
the port leaves them to PyTorch's own operators. Layouts are the JAX
package's: activations (B, S, d), heads (B, S, H, hd), weights (d_in,
d_out) stored flattened.

Attention supports four kinds (full ``attn``, ``local_attn`` with a sliding
window, ``chunked_attn`` with block-diagonal chunks, and NoPE
``global_attn``) over one masked-softmax core with two execution paths:
dense einsum (short sequences) and a loop over KV blocks with a running
max and denominator (flash attention in plain torch) for long ones.

One deliberate difference from the reference: :func:`attn_mask` also
masks key slots whose position is negative. Positions are never negative,
so only empty cache slots (``kpos = -10**9``) and padded KV blocks are
affected; the reference attends to them (ROADMAP queue 3).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------- init utils

def draw(gen, shape, uniform=False):
    """f32 standard normals (``uniform``: U[0, 1)) of ``shape`` from the
    ``torch.Generator`` ``gen`` on its device. ``gen`` None draws nothing:
    an uninitialised tensor on the meta device (the shape-only path of
    ``models.model.param_shapes``)."""
    if gen is None:
        return torch.empty(shape, dtype=F32, device="meta")
    fn = torch.rand if uniform else torch.randn
    return fn(shape, generator=gen, device=gen.device, dtype=F32)


def dense_init(gen, d_in, d_out, dtype, scale=None, device=None):
    """(d_in, d_out) normal / sqrt(d_in) (or ``scale``), drawn in f32 from
    ``gen`` on its device (:func:`draw`) and cast to ``dtype`` on
    ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = draw(gen, (d_in, d_out)) * scale
    return w.to(device=device or w.device, dtype=dtype)


def norm_init(d, norm_kind, dtype, device):
    if norm_kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


# --------------------------------------------------------------------- norms

def apply_norm(params, x, norm_kind, eps=1e-6):
    xf = x.to(F32)
    if norm_kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * params["w"].to(F32)).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["w"].to(F32) + params["b"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------- RoPE

def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions[..., None].to(F32) * freqs                # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attn_mask(qpos, kpos, kind, window=0, chunk=0, causal=True):
    """Boolean mask (Sq, Skv): True = attend. A key slot whose position is
    negative (an empty cache slot or a padded block) is never attended."""
    q = qpos[:, None]
    k = kpos[None, :]
    m = (q >= k) if causal else torch.ones(
        (qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=kpos.device)
    m = m & (k >= 0)
    if kind == "local_attn":
        m = m & (q - k < window)
    elif kind == "chunked_attn":
        m = m & (torch.div(q, chunk, rounding_mode="floor")
                 == torch.div(k, chunk, rounding_mode="floor"))
    return m


def _dense_attention(q, k, v, qpos, kpos, kind, window, chunk, causal, scale):
    """Grouped GQA attention: q (B,Sq,Hkv,G,hd), k/v (B,Skv,Hkv,hd) — the KV
    heads are never materialized repeated."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(F32) * scale
    m = attn_mask(qpos, kpos, kind, window, chunk, causal)
    s = torch.where(m[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _flash_attention(q, k, v, qpos, kpos, kind, window, chunk, causal, scale,
                     kv_block=1024, q_block=1024):
    """Memory-efficient grouped attention: a loop over Q blocks x KV blocks
    with a running softmax (the reference's ``lax.scan``). q:
    (B,Sq,Hkv,G,hd); k/v: (B,Skv,Hkv,hd). Memory is O(q_block * kv_block)
    per step."""
    B, Sq, Hkv, G, hd = q.shape
    if Sq > q_block and Sq % q_block == 0:
        # blocks taken once (here and below): the backward of a split is
        # one cat, where a slice per block would write and sum a zeroed
        # gradient of the whole input per block
        outs = [_flash_attention(qb, k, v, pb, kpos, kind, window, chunk,
                                 causal, scale, kv_block, q_block)
                for qb, pb in zip(q.split(q_block, dim=1),
                                  qpos.split(q_block))]
        return torch.cat(outs, dim=1)
    Skv = k.shape[1]
    nb = -(-Skv // kv_block)
    pad = nb * kv_block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-10**9)          # masked out
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=F32, device=q.device)
    for kb, vb, kp in zip(k.split(kv_block, dim=1), v.split(kv_block, dim=1),
                          kpos.split(kv_block)):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q, kb).to(F32) * scale
        mask = attn_mask(qpos, kp, kind, window, chunk, causal)
        s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb).to(F32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)           # (B,Sq,Hkv,G,hd)


def attention(q, k, v, qpos, kpos, kind="attn", window=0, chunk=0, causal=True,
              flash_threshold=8192, kv_block=1024):
    """GQA attention. q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd). The query heads
    are grouped as (Hkv, G) so KV is never repeated in memory."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scale = 1.0 / math.sqrt(hd)
    if k.shape[1] > flash_threshold and Sq > 1:
        out = _flash_attention(qg, k, v, qpos, kpos, kind, window, chunk,
                               causal, scale, kv_block)
    else:
        out = _dense_attention(qg, k, v, qpos, kpos, kind, window, chunk,
                               causal, scale)
    return out.reshape(B, Sq, Hq, hd)


# ----------------------------------------------------------------------- MLP

def mlp_init(gen, d, d_ff, act, dtype, device):
    if act == "swiglu":
        return {"gate": dense_init(gen, d, d_ff, dtype, device=device),
                "up": dense_init(gen, d, d_ff, dtype, device=device),
                "down": dense_init(gen, d_ff, d, dtype, device=device)}
    return {"up": dense_init(gen, d, d_ff, dtype, device=device),
            "down": dense_init(gen, d_ff, d, dtype, device=device)}


def mlp_apply(params, x, act):
    if act == "swiglu":
        h = F.silu(x @ params["gate"]) * (x @ params["up"])
    else:
        h = F.gelu(x @ params["up"], approximate="tanh")   # jax.nn.gelu
    return h @ params["down"]


# ------------------------------------------------------------ attention block

def attn_init(gen, cfg, dtype, device):
    """Weights stored flattened (d, H*hd), as the reference stores them."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "q": dense_init(gen, d, hq * hd, dtype, device=device),
        "k": dense_init(gen, d, hkv * hd, dtype, device=device),
        "v": dense_init(gen, d, hkv * hd, dtype, device=device),
        "o": dense_init(gen, hq * hd, d, dtype, scale=1.0 / math.sqrt(hq * hd),
                        device=device),
    }


def qkv(params, x, cfg, positions, use_rope):
    """Project to (B,S,H,hd) q/k/v, applying RoPE if requested."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (x @ params["q"]).reshape(B, S, hq, hd)
    k = (x @ params["k"]).reshape(B, S, hkv, hd)
    v = (x @ params["v"]).reshape(B, S, hkv, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v
