"""Transformer attention blocks with decode caches (port of
``repro/models/transformer.py``).

Decode caches for local/chunked attention are ring buffers of size
window/chunk; a ``kpos`` array records the absolute position held in each
slot, and :func:`~repro_torch.models.layers.attn_mask` masks stale and
empty slots. Decode is batch-uniform (all rows at the same position).

Prefill into a cache longer than the prompt (``Sc > S``, every engine
cache) writes positions ``0..S-1`` into slots ``0..S-1`` and leaves the
rest empty, so decode computes what ``forward`` over the grown sequence
computes. The reference instead takes its ring branch there and fills the
spare slots with copies of real rows under negative positions (ROADMAP
queue 3); with ``Sc <= S`` both keep the last ``Sc`` positions.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (apply_norm, attention, attn_init,
                                       mlp_apply, mlp_init, norm_init, qkv)
from repro_torch.models.moe import moe_apply, moe_init

EMPTY = -10**9                   # kpos of a slot that holds no position


def attn_block_init(gen, cfg, layer_idx, dtype, device, cross=False):
    p = {
        "norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "mlp_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if cross:
        p["cross_norm"] = norm_init(cfg.d_model, cfg.norm, dtype, device)
        p["cross"] = attn_init(gen, cfg, dtype, device)
    if cfg.layer_is_moe(layer_idx):
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device)
    return p


def cache_size(cfg, kind, seq_len):
    if kind == "local_attn":
        return min(cfg.window, seq_len)
    if kind == "chunked_attn":
        return min(cfg.chunk, seq_len)
    return seq_len


def _use_rope(cfg, kind):
    if not cfg.use_rope:
        return False
    return kind != "global_attn"          # NoPE layers (llama4 iRoPE)


def _prefill_cache(cache, k, v, positions):
    """The cache a prefill of S positions leaves behind: slot = position
    mod Sc for the last min(S, Sc) positions, every other slot empty."""
    Sc, S = cache["k"].shape[1], k.shape[1]
    tail = torch.arange(max(0, S - Sc), S, device=k.device)
    slots = tail % Sc
    kc = torch.zeros_like(cache["k"])
    vc = torch.zeros_like(cache["v"])
    kc[:, slots] = k[:, tail].to(kc.dtype)
    vc[:, slots] = v[:, tail].to(vc.dtype)
    kpos = torch.full((Sc,), EMPTY, dtype=torch.int32, device=k.device)
    kpos[slots] = positions[tail].to(torch.int32)
    return {"k": kc, "v": vc, "kpos": kpos}


def _cross_attend(p, x, cfg, cache, new_cache, enc_out, fth, kv_block):
    """Cross attention over the encoder's output: fresh K/V from
    ``enc_out``, or the cached ``ck``/``cv`` at decode. Every query sits at
    position 0 against keys at 0..Se-1, non-causal. Returns x and the
    cache with ``ck``/``cv`` added."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    xn2 = apply_norm(p["cross_norm"], x, cfg.norm)
    qc = (xn2 @ p["cross"]["q"]).reshape(B, S, H, hd)
    if enc_out is not None:                          # fresh K/V from encoder
        Se = enc_out.shape[1]
        ck = (enc_out @ p["cross"]["k"]).reshape(B, Se, Hkv, hd)
        cv = (enc_out @ p["cross"]["v"]).reshape(B, Se, Hkv, hd)
    else:                                            # decode: from cache
        ck, cv = cache["ck"], cache["cv"]
    epos = torch.arange(ck.shape[1], device=x.device)
    qpos = torch.zeros((S,), dtype=torch.long, device=x.device)
    oc = attention(qc, ck, cv, qpos, epos, "attn", causal=False,
                   flash_threshold=fth, kv_block=kv_block)
    x = x + oc.reshape(B, S, H * hd) @ p["cross"]["o"]
    if new_cache is not None:
        new_cache["ck"], new_cache["cv"] = ck, cv
    elif cache is not None:
        new_cache = {"ck": ck, "cv": cv}
    return x, new_cache


def attn_block_apply(p, x, cfg, kind, rules, positions, *, causal=True,
                     cache=None, pos=None, enc_out=None, opts=None):
    """Returns (x, new_cache). cache: {"k","v","kpos"[,"ck","cv"]} or None
    (forward). With ``pos`` (a decode step) the cache is updated out of
    place: the caller's cache is left as it was, as in the reference. A
    block with cross attention (encoder-decoder) attends, non-causally, to
    K/V projected from ``enc_out`` (prefill, forward) or to the cached
    ``ck``/``cv`` (decode). ``rules`` (``dist.sharding.Rules`` or None)
    reaches the MoE slot only: every other operator is the same
    computation on one device whatever the batch's sharding."""
    B, S, d = x.shape
    H, hd = cfg.num_heads, cfg.hd
    xn = apply_norm(p["norm"], x, cfg.norm)
    q, k, v = qkv(p["attn"], xn, cfg, positions, _use_rope(cfg, kind))
    new_cache = None
    kv_block = opts.kv_block if opts else 1024
    fth = opts.flash_threshold if opts else 8192
    if cache is not None and pos is not None:        # decode step
        Sc = cache["k"].shape[1]
        slot = int(pos) % Sc
        kc, vc, kpos = (cache["k"].clone(), cache["v"].clone(),
                        cache["kpos"].clone())
        kc[:, slot:slot + S] = k.to(kc.dtype)
        vc[:, slot:slot + S] = v.to(vc.dtype)
        kpos[slot] = int(pos)
        o = attention(q, kc, vc, positions, kpos, kind, cfg.window, cfg.chunk,
                      causal=True, flash_threshold=fth, kv_block=kv_block)
        new_cache = {"k": kc, "v": vc, "kpos": kpos}
    else:
        o = attention(q, k, v, positions, positions, kind, cfg.window,
                      cfg.chunk, causal=causal, flash_threshold=fth,
                      kv_block=kv_block)
        if cache is not None:                        # prefill: fill the cache
            new_cache = _prefill_cache(cache, k, v, positions)
    x = x + o.reshape(B, S, H * hd) @ p["attn"]["o"]
    if "cross" in p:                                 # encoder-decoder cross attn
        x, new_cache = _cross_attend(p, x, cfg, cache, new_cache, enc_out,
                                     fth, kv_block)
    xn3 = apply_norm(p["mlp_norm"], x, cfg.norm)
    if "moe" in p:
        y = moe_apply(p["moe"], xn3, cfg, rules,
                      overlap=(opts.moe_overlap if opts else False),
                      quantize=(opts.moe_quantize if opts else False),
                      backend=(opts.moe_backend if opts else "xla"))
    else:
        y = mlp_apply(p["mlp"], xn3, cfg.act)
    return x + y, new_cache
