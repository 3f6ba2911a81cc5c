"""Model assembly: init / prefill / decode (port of
``repro/models/model.py``) for every block kind the reference builds:
attention (dense and MoE), the recurrent blocks (mLSTM and sLSTM in
``models/xlstm.py``, RG-LRU in ``models/rglru.py``) and the
encoder-decoder (whisper: a stack of non-causal encoder blocks over the
frame embeddings, and cross attention in every decoder block).

Layers are stacked over *repeat units* (the lcm of the block pattern and
the MoE interleave): every parameter and cache leaf carries the repeat
axis first, ``(R, ...)``, as in the reference, and :func:`apply_blocks`
loops over it where the reference runs ``jax.lax.scan``. Parameters are
nested dicts of tensors with the reference's keys, so
:func:`params_from_numpy` carries the JAX package's weights across leaf
for leaf.

``rules`` (a ``dist.sharding.Rules`` over a ``VirtualMesh``, or None)
reaches the MoE layers, which shard the batch and the experts over the
mesh's ranks (``models/moe.py``); every other operator computes the
same on one device whatever the sharding. :func:`param_specs` and
:func:`cache_specs` give the reference's specs (``dist.sharding.P``) of
the parameters and the decode cache under ``rules``.

Training: :func:`train_loss` is the masked next-token cross entropy over
:func:`forward` (optionally in sequence chunks, ``loss_chunk``), and its
gradient is autograd's. Under ``StepOptions.remat`` (the default), when
autograd is recording, each repeat unit of :func:`apply_blocks` and each
encoder block runs under ``torch.utils.checkpoint`` (non-reentrant): the
unit the reference wraps in ``jax.checkpoint``, so only the unit's input
is kept and its activations are recomputed in the backward pass.
Prefill and decode run under ``no_grad`` and take no checkpoint. A
recorder (``dist.mesh.record``, ``models.moe.record_routes``) inside a
checkpointed forward also logs the recomputation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import RECURRENT_KINDS
from repro_torch.dist.sharding import P, tree_leaves, tree_map
from repro_torch.models.layers import (apply_norm, dense_init, mlp_apply,
                                       mlp_init, norm_init)
from repro_torch.models.moe import kernel_weights, moe_param_specs
from repro_torch.models.rglru import (rglru_apply, rglru_init,
                                      rglru_init_state, rglru_state_shape)
from repro_torch.models.transformer import (EMPTY, attn_block_apply,
                                            attn_block_init, cache_size)
from repro_torch.models.xlstm import (mlstm_apply, mlstm_init,
                                      mlstm_init_state, mlstm_state_shape,
                                      slstm_apply, slstm_init,
                                      slstm_init_state, slstm_state_shape)

F32 = torch.float32
MAX_LEARNED_POS = 32768
F32_LEAVES = ("router", "lam")   # leaves the reference keeps in float32


@dataclass(frozen=True)
class StepOptions:
    """The reference's step-level knobs. ``scan_layers``, ``seq_parallel``
    and ``sp_residuals`` only place work in the reference (a scan over the
    repeats, sharding constraints on the activations); ``Rules.shard`` is
    the identity on a ``VirtualMesh`` and the port loops over the repeats,
    so they are accepted and change nothing."""
    remat: bool = True               # checkpoint each repeat unit (training)
    moe_overlap: bool = False        # CUCo self/remote split dispatch hiding
    moe_quantize: bool = False       # int8 dispatch (paper's quantize phase)
    moe_backend: str = "xla"         # "pallas": the moe_dispatch.cu kernel
    kv_block: int = 1024             # flash KV block
    flash_threshold: int = 8192
    scan_layers: bool = True
    loss_chunk: int = 0              # >0: chunked CE loss (seq chunks)
    seq_parallel: bool = False       # prefill: activations sharded over seq
    sp_residuals: bool = False       # train: remat carries sharded over seq


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack(trees):
    """Stack a list of same-shaped nested dicts leaf by leaf on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# =============================================================== param init

def _block_init(gen, cfg, slot, dtype, device):
    kind = cfg.block_kind(slot)
    if kind == "mlstm":
        return mlstm_init(gen, cfg, dtype, device)
    if kind == "slstm":
        return slstm_init(gen, cfg, dtype, device)
    if kind == "rglru":
        return {"rglru": rglru_init(gen, cfg, dtype, device),
                "mlp_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                device)}
    return attn_block_init(gen, cfg, slot, dtype, device,
                           cross=cfg.is_encoder_decoder)


def init_params(gen, cfg, device="cuda"):
    """Random weights of the reference's shapes and scales, drawn from the
    ``torch.Generator`` ``gen`` on its device and placed on ``device``.
    (The numbers differ from the reference's ``jax.random`` draws; tests
    carry the reference's weights over with :func:`params_from_numpy`.)
    ``gen`` None with ``device="meta"`` draws nothing (:func:`param_shapes`)."""
    dtype = _dtype(cfg)
    Vp, d = cfg.vocab_padded, cfg.d_model
    params = {"embed": dense_init(gen, Vp, d, dtype, scale=0.02,
                                  device=device)}
    if cfg.learned_pos:
        params["pos"] = dense_init(gen, MAX_LEARNED_POS, d, dtype, scale=0.02,
                                   device=device)
    R = cfg.num_repeats
    params["blocks"] = {
        f"s{i}": _stack([_block_init(gen, cfg, i, dtype, device)
                         for _ in range(max(R, 1))])
        for i in range(cfg.repeat_unit)}
    if R == 0:                  # no layer stack: (0, ...) leaves
        params["blocks"] = tree_map(lambda a: a[:0].clone(), params["blocks"])
    params["final_norm"] = norm_init(d, cfg.norm, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, Vp, dtype, device=device)
    if cfg.is_encoder_decoder:
        params["enc"] = {
            "pos": dense_init(gen, cfg.enc_seq, d, dtype, scale=0.02,
                              device=device),
            "blocks": _stack([attn_block_init(gen, cfg, 10**6, dtype, device)
                              for _ in range(cfg.enc_layers)]),  # never MoE
            "final_norm": norm_init(d, cfg.norm, dtype, device),
        }
    return params


def param_shapes(cfg):
    """:func:`init_params`' tree as :class:`ShapeDtype` leaves, drawing no
    number (the reference's ``jax.eval_shape(init_params)``): every draw
    is an uninitialised tensor on the meta device, so a model of any size
    costs only its metadata."""
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype),
                    init_params(None, cfg, device="meta"))


def params_from_numpy(tree, cfg, device="cuda"):
    """The reference's ``init_params`` tree, as numpy arrays (same
    nesting, stacked ``(R, ...)`` leaves), as the port's params on
    ``device``. bf16 leaves arrive as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses: they cross as float32 (bf16 -> f32 ->
    bf16 is exact). The leaves the reference keeps in float32 whatever the
    config's type (``F32_LEAVES``: the MoE router and RG-LRU's ``lam``)
    stay float32."""
    dtype = _dtype(cfg)

    def convert(node, name=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device=device,
                    dtype=F32 if name in F32_LEAVES else dtype)

    return convert(tree)


# =============================================================== param specs

def _norm_spec(cfg):
    return {"w": P(None)} if cfg.norm == "rmsnorm" else {"w": P(None),
                                                         "b": P(None)}


def _attn_specs(cfg, rules, cross):
    sp = {
        "norm": _norm_spec(cfg),
        "attn": {"q": P(None, rules.axes("heads")),
                 "k": P(None, rules.axes("kv_heads")),
                 "v": P(None, rules.axes("kv_heads")),
                 "o": P(rules.axes("heads"), None)},
        "mlp_norm": _norm_spec(cfg),
    }
    if cross:
        sp["cross_norm"] = sp["norm"]
        sp["cross"] = sp["attn"]
    return sp


def _mlp_specs(cfg, rules):
    ff = rules.axes("ff")
    if cfg.act == "swiglu":
        return {"gate": P(None, ff), "up": P(None, ff), "down": P(ff, None)}
    return {"up": P(None, ff), "down": P(ff, None)}


def _block_specs(cfg, slot, rules):
    kind = cfg.block_kind(slot)
    ff = rules.axes("ff")
    if kind == "mlstm":
        return {"norm": _norm_spec(cfg), "up": P(None, ff), "q": P(None, ff),
                "k": P(None, ff), "v": P(None, ff), "wi": P(None, None),
                "wf": P(None, None), "bf": P(None), "bi": P(None),
                "hnorm": {"w": P(None)}, "down": P(ff, None)}
    if kind == "slstm":
        return {"norm": _norm_spec(cfg), "w": P(None, ff),
                "r": P(None, None, None), "b": P(None),
                "ffn_norm": _norm_spec(cfg), "ff_gate": P(None, ff),
                "ff_up": P(None, ff), "ff_down": P(ff, None)}
    if kind == "rglru":
        return {"rglru": {"norm": _norm_spec(cfg), "in_a": P(None, ff),
                          "in_b": P(None, ff), "conv_w": P(None, ff),
                          "conv_b": P(ff), "wr": P(None, ff),
                          "wi": P(None, ff), "lam": P(ff),
                          "out": P(ff, None)},
                "mlp_norm": _norm_spec(cfg),
                "mlp": _mlp_specs(cfg, rules)}
    sp = _attn_specs(cfg, rules, cfg.is_encoder_decoder)
    if cfg.layer_is_moe(slot):
        sp["moe"] = moe_param_specs(cfg, rules)
    else:
        sp["mlp"] = _mlp_specs(cfg, rules)
    return sp


def _prepend(spec, extra=None):
    """Add the leading stacking dim (repeats) to every leaf spec."""
    return tree_map(lambda s: P(extra, *s), spec)


def param_specs(cfg, rules):
    """Tree of specs matching ``init_params(cfg)``, as the reference's
    (not checked for divisibility: ``dist.sharding.sanitize_specs``)."""
    vocab = rules.axes("vocab")
    specs = {"embed": P(vocab, None)}
    if cfg.learned_pos:
        specs["pos"] = P(None, None)
    specs["blocks"] = {f"s{i}": _prepend(_block_specs(cfg, i, rules))
                       for i in range(cfg.repeat_unit)}
    specs["final_norm"] = _norm_spec(cfg)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, vocab)
    if cfg.is_encoder_decoder:
        specs["enc"] = {
            "pos": P(None, None),
            "blocks": _prepend(_attn_specs(cfg, rules, cross=False)
                               | {"mlp": _mlp_specs(cfg, rules)}),
            "final_norm": _norm_spec(cfg),
        }
    return specs


def with_kernel_weights(params, cfg):
    """``params`` with each MoE layer's f32 kernel operands built once
    (``moe.kernel_weights`` under ``["moe"]["kernel"]``, stacked like the
    other leaves), for ``moe_backend="pallas"``: the kernel wants f32
    ``[wg | wu]`` and ``wd``, and a cast per call would read and write
    every expert weight again at each step. The input is left as it was;
    the new tree shares its tensors."""
    blocks = dict(params["blocks"])
    for i in range(cfg.repeat_unit):
        key = f"s{i}"
        if "moe" in blocks[key]:
            moe = dict(blocks[key]["moe"])
            moe["kernel"] = kernel_weights(moe)
            blocks[key] = dict(blocks[key], moe=moe)
    return dict(params, blocks=blocks)


# ============================================================ embed / logits

def embed_lookup(embed, ids):
    """Embedding lookup (the reference's ``rules=None`` path)."""
    return embed[ids]


def lm_logits(params, x, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ w.to(x.dtype)).to(F32)
    Vp = logits.shape[-1]
    if Vp > cfg.vocab_size:
        valid = torch.arange(Vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits


# ================================================================== caches

def init_cache(cfg, B, seq_len, dtype=None, device="cuda"):
    """Decode cache, per repeat slot. Attention: ``{"k", "v"}`` of (R, B,
    Sc, Hkv, hd) and ``"kpos"`` (R, Sc), every slot empty, plus ``"ck"``,
    ``"cv"`` of (R, B, enc_seq, Hkv, hd) in an encoder-decoder. A recurrent
    slot holds its block's initial state with R in front."""
    dtype = dtype or _dtype(cfg)
    R, Hkv, hd = cfg.num_repeats, cfg.num_kv_heads, cfg.hd
    out = {}
    for i in range(cfg.repeat_unit):
        kind = cfg.block_kind(i)
        if kind in RECURRENT_KINDS:
            st = (mlstm_init_state(cfg, B, device=device) if kind == "mlstm"
                  else slstm_init_state(cfg, B, device=device)
                  if kind == "slstm"
                  else rglru_init_state(cfg, B, dtype, device=device))
            out[f"s{i}"] = {k: v.expand((R,) + v.shape).clone()
                            for k, v in st.items()}
            continue
        Sc = cache_size(cfg, kind, seq_len)
        c = {"k": torch.zeros((R, B, Sc, Hkv, hd), dtype=dtype, device=device),
             "v": torch.zeros((R, B, Sc, Hkv, hd), dtype=dtype, device=device),
             "kpos": torch.full((R, Sc), EMPTY, dtype=torch.int32,
                                device=device)}
        if cfg.is_encoder_decoder:
            c["ck"] = torch.zeros((R, B, cfg.enc_seq, Hkv, hd), dtype=dtype,
                                  device=device)
            c["cv"] = torch.zeros_like(c["ck"])
        out[f"s{i}"] = c
    return out


class ShapeDtype(NamedTuple):
    """A leaf's shape and type (the reference's ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def cache_specs(cfg, B, seq_len, rules):
    """The decode cache's leaves as :class:`ShapeDtype` records, and their
    specs (divisibility-checked ``rules.param_spec``), in
    :func:`init_cache`'s structure."""
    dtype = _dtype(cfg)
    R, Hkv, hd = cfg.num_repeats, cfg.num_kv_heads, cfg.hd
    shapes, specs = {}, {}
    for i in range(cfg.repeat_unit):
        kind = cfg.block_kind(i)
        if kind in RECURRENT_KINDS:
            sh = (mlstm_state_shape(cfg, B) if kind == "mlstm" else
                  slstm_state_shape(cfg, B) if kind == "slstm" else
                  rglru_state_shape(cfg, B))
            shapes[f"s{i}"] = {k: ShapeDtype(
                (R,) + v, dtype if (kind == "rglru" and k == "conv") else F32)
                for k, v in sh.items()}
            specs[f"s{i}"] = {k: rules.param_spec((R,) + v, None, "batch",
                                                  *([None] * (len(v) - 1)))
                              for k, v in sh.items()}
            continue
        Sc = cache_size(cfg, kind, seq_len)
        kv_shape = (R, B, Sc, Hkv, hd)
        shapes[f"s{i}"] = {"k": ShapeDtype(kv_shape, dtype),
                           "v": ShapeDtype(kv_shape, dtype),
                           "kpos": ShapeDtype((R, Sc), torch.int32)}
        kv_spec = rules.param_spec(kv_shape, None, "batch", "seq_kv", None,
                                   None)
        specs[f"s{i}"] = {"k": kv_spec, "v": kv_spec, "kpos": P(None, None)}
        if cfg.is_encoder_decoder:
            csh = (R, B, cfg.enc_seq, Hkv, hd)
            cs = rules.param_spec(csh, None, "batch", None, None, None)
            for leaf in ("ck", "cv"):
                shapes[f"s{i}"][leaf] = ShapeDtype(csh, dtype)
                specs[f"s{i}"][leaf] = cs
    return shapes, specs


# ================================================================ forward

def _apply_block(p, x, cfg, slot, rules, positions, *, causal, cache, pos,
                 enc_out, opts):
    kind = cfg.block_kind(slot)
    if kind == "mlstm":
        return mlstm_apply(p, x, cfg, state=cache, decode=pos is not None)
    if kind == "slstm":
        return slstm_apply(p, x, cfg, state=cache, decode=pos is not None)
    if kind == "rglru":
        x, st = rglru_apply(p["rglru"], x, cfg, state=cache,
                            decode=pos is not None)
        xn = apply_norm(p["mlp_norm"], x, cfg.norm)
        return x + mlp_apply(p["mlp"], xn, cfg.act), st
    return attn_block_apply(p, x, cfg, kind, rules, positions, causal=causal,
                            cache=cache, pos=pos, enc_out=enc_out, opts=opts)


def _recording(*trees):
    """True where autograd records a graph through any tensor of
    ``trees``: grad mode on and one of them requiring grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for tree in trees for t in tree_leaves(tree))


def _remat(fn, *args):
    """``fn(*args)`` under a non-reentrant activation checkpoint: only the
    arguments are kept for the backward pass, which runs ``fn`` again. The
    forward draws no random numbers, so no RNG state is kept."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _call(fn, *args):
    return fn(*args)


def _unstack(tree):
    """Each stacked ``(R, ...)`` leaf of ``tree`` as its R repeats' views,
    taken once. Under autograd their backward stacks the R gradients into
    one ``(R, ...)`` tensor; a select of each repeat would write a zeroed
    ``(R, ...)`` gradient per repeat and sum the R of them, traffic that
    grows as R squared."""
    return tree_map(lambda a: a.unbind(0), tree)


def apply_blocks(params_blocks, x, cfg, rules, positions, *, causal=True,
                 cache=None, pos=None, enc_out=None, opts=None,
                 return_cache=False):
    """Every layer in order: repeat ``r`` applies slot ``s0..s{unit-1}``
    with their ``[r]`` parameters (and cache). Returns ``(x, caches)``,
    caches stacked ``(R, ...)`` like the input (``None`` unless
    ``return_cache``). With ``opts.remat``, no ``pos`` and autograd
    recording, each repeat runs under an activation checkpoint."""
    opts = opts or StepOptions()
    unit, R = cfg.repeat_unit, cfg.num_repeats
    layers = _unstack(params_blocks)

    def unit_fn(x, r, enc_out):
        new = {}
        for i in range(unit):
            key = f"s{i}"
            p = tree_map(lambda a: a[r], layers[key])
            c = tree_map(lambda a: a[r], cache[key]) if cache is not None \
                else None
            x, new[key] = _apply_block(p, x, cfg, i, rules, positions,
                                       causal=causal, cache=c, pos=pos,
                                       enc_out=enc_out, opts=opts)
        return x, new

    run = _remat if opts.remat and pos is None and _recording(
        params_blocks, {"x": x, "enc": enc_out}) else _call
    per_r = []
    for r in range(R):
        x, new = run(unit_fn, x, r, enc_out)
        per_r.append(new)
    if not return_cache or not per_r or per_r[0]["s0"] is None:
        return x, None
    return x, {key: _stack([c[key] for c in per_r]) for key in per_r[0]}


def encode(params, frames, cfg, rules=None, opts=None):
    """Whisper encoder over stub frame embeddings (B, enc_seq, d):
    non-causal attention blocks, then the encoder's final norm."""
    opts = opts or StepOptions()
    x = frames + params["enc"]["pos"][None, :frames.shape[1]].to(frames.dtype)
    positions = torch.arange(frames.shape[1], device=frames.device)
    blocks = params["enc"]["blocks"]
    layers = _unstack(blocks)

    def block(x, layer):
        return attn_block_apply(tree_map(lambda a: a[layer], layers), x,
                                cfg, "attn", rules, positions, causal=False,
                                opts=opts)[0]

    run = _remat if opts.remat and _recording(blocks, {"x": x}) else _call
    for layer in range(cfg.enc_layers):
        x = run(block, x, layer)
    return apply_norm(params["enc"]["final_norm"], x, cfg.norm)


def forward(params, batch, cfg, rules=None, opts=None, return_cache=False,
            cache=None):
    """Prefill forward. batch: ``{"tokens"[, "patches" | "frames"]}``
    (``frames`` (B, enc_seq, d) for an encoder-decoder). Returns the
    final-normed hidden states and the filled cache."""
    opts = opts or StepOptions()
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(_dtype(cfg))
    if cfg.num_patch_tokens and "patches" in batch:
        Pn = batch["patches"].shape[1]
        x = torch.cat([batch["patches"].to(x.dtype), x[:, Pn:]], dim=1)
    if cfg.learned_pos:
        x = x + params["pos"][:S][None].to(x.dtype)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, batch["frames"].to(x.dtype), cfg, rules,
                         opts)
    positions = torch.arange(S, device=tokens.device)
    x, new_cache = apply_blocks(params["blocks"], x, cfg, rules, positions,
                                causal=True, cache=cache, enc_out=enc_out,
                                opts=opts, return_cache=return_cache)
    return apply_norm(params["final_norm"], x, cfg.norm), new_cache


def _ce_terms(params, x, labels, cfg):
    """Summed next-token NLL over the positions whose label is not
    negative, and their count (a float32 0-d tensor each)."""
    logits = lm_logits(params, x, cfg)
    mask = labels >= 0
    labels_c = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll), torch.sum(mask).to(F32)


def train_loss(params, batch, cfg, rules=None, opts=None):
    """Mean next-token cross entropy of ``batch`` (``{"tokens", "labels"[,
    "patches" | "frames"]}``; label -1 is not scored) under ``params``.
    With ``opts.loss_chunk`` dividing the sequence (and shorter than it),
    the loss is taken over sequence chunks, each under an activation
    checkpoint, so the full (B, S, V) logits never exist at once."""
    opts = opts or StepOptions()
    x, _ = forward(params, batch, cfg, rules, opts)
    labels = batch["labels"]
    S = labels.shape[1]
    ck = opts.loss_chunk
    if ck and S % ck == 0 and S > ck:
        nll = cnt = torch.zeros((), dtype=F32, device=x.device)
        run = _remat if _recording(params, {"x": x}) else _call
        for j in range(0, S, ck):
            n, c = run(_ce_terms, params, x[:, j:j + ck],
                       labels[:, j:j + ck], cfg)
            nll, cnt = nll + n, cnt + c
        return nll / torch.clamp(cnt, min=1)
    nll, cnt = _ce_terms(params, x, labels, cfg)
    return nll / torch.clamp(cnt, min=1)


def prefill_step(params, batch, cfg, rules=None, seq_len=None, opts=None):
    """Prefill: build the decode cache + last-position logits."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, seq_len or S, device=tokens.device)
    x, new_cache = forward(params, batch, cfg, rules, opts, return_cache=True,
                           cache=cache)
    return lm_logits(params, x[:, -1:], cfg), new_cache


def decode_step(params, cache, token, pos, cfg, rules=None, opts=None):
    """One decode step. token: (B, 1) int; pos: int. The cache passed in
    is left unchanged."""
    pos = int(pos)
    x = embed_lookup(params["embed"], token).to(_dtype(cfg))
    if cfg.learned_pos:
        p = pos % MAX_LEARNED_POS
        x = x + params["pos"][p:p + 1][None].to(x.dtype)
    positions = torch.full((1,), pos, device=token.device)
    x, new_cache = apply_blocks(params["blocks"], x, cfg, rules, positions,
                                causal=True, cache=cache, pos=pos, opts=opts,
                                return_cache=True)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, x, cfg), new_cache
