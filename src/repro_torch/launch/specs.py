"""Shape-and-type stand-ins and specs for every (arch x shape) cell (port
of ``repro/launch/specs.py``).

``input_specs()`` returns the step function of each cell kind, its
arguments as :class:`~repro_torch.models.model.ShapeDtype` trees (no
tensor made, no number drawn: :func:`~repro_torch.models.param_shapes`)
and their specs (:class:`~repro_torch.dist.sharding.P`):

  train_4k    -> train_step(params, opt_state, batch)
  prefill_32k -> prefill_step(params, batch)
  decode_32k / long_500k -> serve_step(params, cache, token, pos)

:func:`stand_ins` makes the stand-ins tensors: uninitialised tensors on
the meta device (``core/op_count.py`` traces a step over them at any
size), or zeros on another device. A 0-d leaf (the optimizer's step, the
decode position) is a zero on the host whatever ``device``: the port reads
both as Python numbers (``optim/adamw.py``, ``models.decode_step``).

The train step is the loss, its gradients and :func:`adamw_update` (in
place: the parameters and the optimizer state are donated, as the
reference donates them); prefill and decode run under ``no_grad`` (decode
donates the cache).
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import P, Rules, sanitize_specs, tree_map
from repro_torch.models import (StepOptions, cache_specs, decode_step,
                                param_shapes, param_specs, prefill_step)
from repro_torch.models.model import ShapeDtype
from repro_torch.optim import AdamWConfig, adamw_update, opt_state_specs
from repro_torch.train.loop import loss_and_grads

SDS = ShapeDtype
I32, F32, BF16 = torch.int32, torch.float32, torch.bfloat16


def rules_for(mesh, shape):
    kind = "decode" if shape.kind == "decode" else shape.kind
    return Rules(mesh, kind, long_context=(shape.seq_len > 100_000))


def batch_sds(cfg, shape, with_labels):
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": SDS((B, S), I32)}
    if with_labels:
        out["labels"] = SDS((B, S), I32)
    if cfg.is_encoder_decoder:
        out["frames"] = SDS((B, cfg.enc_seq, cfg.d_model), BF16)
    if cfg.num_patch_tokens:
        out["patches"] = SDS((B, cfg.num_patch_tokens, cfg.d_model), BF16)
    return out


def batch_shardings(cfg, shape, rules):
    b = rules.axes("batch")
    dp = rules.dp_size()
    if not (dp and shape.global_batch % dp == 0 and shape.global_batch >= dp):
        b = None
    out = {"tokens": P(b, None)}
    if shape.kind == "train":
        out["labels"] = P(b, None)
    if cfg.is_encoder_decoder:
        out["frames"] = P(b, None, None)
    if cfg.num_patch_tokens:
        out["patches"] = P(b, None, None)
    return out


def opt_state_sds(p_sds):
    """``init_opt_state``'s tree for parameters of ``p_sds``: f32 moments
    and master copy, an int32 step."""
    f32 = tree_map(lambda s: SDS(s.shape, F32), p_sds)
    return {"m": f32, "v": f32, "master": f32, "step": SDS((), I32)}


def stand_ins(tree, device="meta"):
    """A :class:`ShapeDtype` tree (or a tuple of them, as
    :func:`input_specs` gives the arguments) as tensors on ``device``
    (uninitialised on meta, zeros elsewhere); every 0-d leaf a zero on the
    host."""
    if isinstance(tree, tuple) and not isinstance(tree, ShapeDtype):
        return tuple(stand_ins(t, device) for t in tree)

    def make(s):
        if not s.shape:
            return torch.zeros((), dtype=s.dtype)
        if torch.device(device).type == "meta":
            return torch.empty(s.shape, dtype=s.dtype, device="meta")
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    return tree_map(make, tree)


def make_train_step(cfg, rules, opts: StepOptions, opt_cfg: AdamWConfig):
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, rules, opts)
        new_params, new_state, gnorm = adamw_update(params, grads, opt_state,
                                                    opt_cfg)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg, rules, opts: StepOptions, seq_len):
    @torch.no_grad()
    def prefill(params, batch):
        return prefill_step(params, batch, cfg, rules, seq_len=seq_len,
                            opts=opts)
    return prefill


def make_serve_step(cfg, rules, opts: StepOptions):
    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        return decode_step(params, cache, token, pos, cfg, rules, opts=opts)
    return serve_step


def input_specs(cfg, shape, mesh, opts: StepOptions | None = None,
                opt_cfg: AdamWConfig | None = None):
    """Returns (step_fn, in_sds tuple, in_specs tuple, donate_argnums)."""
    opts = opts or StepOptions()
    opt_cfg = opt_cfg or AdamWConfig()
    rules = rules_for(mesh, shape)
    p_sds = param_shapes(cfg)
    p_specs = sanitize_specs(param_specs(cfg, rules), p_sds, mesh) \
        if mesh is not None else tree_map(lambda _: P(), p_sds)
    b_sds = batch_sds(cfg, shape, with_labels=(shape.kind == "train"))
    b_specs = batch_shardings(cfg, shape, rules)

    if shape.kind == "train":
        o_sds = opt_state_sds(p_sds)
        o_specs = opt_state_specs(p_specs, p_sds, rules) if mesh is not None \
            else tree_map(lambda _: P(), o_sds)
        fn = make_train_step(cfg, rules, opts, opt_cfg)
        return fn, (p_sds, o_sds, b_sds), (p_specs, o_specs, b_specs), (0, 1)

    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, rules, opts, shape.seq_len)
        return fn, (p_sds, b_sds), (p_specs, b_specs), ()

    # decode: one new token against a seq_len-deep cache
    c_sds, c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len, rules)
    if mesh is not None:
        c_specs = sanitize_specs(c_specs, c_sds, mesh)
    else:
        c_specs = tree_map(lambda _: P(), c_sds)
    b = rules.axes("batch")
    dp = rules.dp_size()
    if not (dp and shape.global_batch % dp == 0 and shape.global_batch >= dp):
        b = None
    tok_sds = SDS((shape.global_batch, 1), I32)
    pos_sds = SDS((), I32)
    fn = make_serve_step(cfg, rules, opts)
    return fn, (p_sds, c_sds, tok_sds, pos_sds), \
        (p_specs, c_specs, P(b, None), P()), (1,)
