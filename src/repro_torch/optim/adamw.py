"""AdamW with f32 master weights + moments, global-norm clipping, cosine
schedule, and ZeRO-style state sharding (port of ``repro/optim/adamw.py``:
moments/master additionally sharded over the data axis via ``zero_spec``).

The state is the reference's tree, ``{"m", "v", "master", "step"}``: ``m``,
``v`` and ``master`` float32 on the parameters' device, ``step`` an int32
0-d tensor on the host. The step is read on every update to set the
learning rate and the bias corrections as Python numbers; on the card a
device step would make each update wait for the device.

:func:`adamw_update` runs in place, leaf by leaf: a full-width model holds
its parameters, gradients and three f32 state trees already, and an
out-of-place update would add a fourth and fifth. It keeps the reference's
order: the global-norm clip in f32, ``m2 = b1*m + (1-b1)*g`` and ``v2 =
b2*v + (1-b2)*g*g``, the bias corrections ``c1`` and ``c2``, the decoupled
weight decay on the f32 master (taken from the master before the step),
and the parameter written back in its own dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.dist.sharding import P, tree_leaves, tree_map, zero_spec

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int, or a 0-d tensor): linear
    warm-up to ``peak_lr``, then a cosine decay to ``min_lr_frac`` of it
    at ``total_steps``."""
    step = float(step)
    if step < cfg.warmup_steps:
        return cfg.peak_lr * step / max(1, cfg.warmup_steps)
    t = min(1.0, max(0.0, (step - cfg.warmup_steps)
                     / max(1, cfg.total_steps - cfg.warmup_steps)))
    return cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))


def init_opt_state(params):
    """Zero moments and an f32 copy of ``params`` (same nesting), and the
    step counter at 0."""
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                device=p.device), params),
            "master": tree_map(lambda p: p.detach().to(F32, copy=True),
                               params),
            "step": torch.zeros((), dtype=torch.int32)}


def opt_state_specs(param_spec_tree, param_shapes, rules):
    """Specs for the opt state: params' specs + ZeRO extra data-sharding.
    ``param_shapes``: a tree of the params' nesting whose leaves have
    ``.shape``."""
    zt = tree_map(lambda spec, s: zero_spec(spec, tuple(s.shape), rules),
                  param_spec_tree, param_shapes)
    return {"m": zt, "v": zt, "master": zt, "step": P()}


def global_norm(grads):
    """The gradients' global L2 norm in f32: a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place: ``params`` and every leaf of ``state``
    are updated where they lie, and returned with the pre-clip gradient
    norm, as the reference returns ``(params, state, gnorm)``. ``grads`` is
    read only."""
    step = int(state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_at(cfg, step)
    c1 = 1 - cfg.b1 ** step
    c2 = 1 - cfg.b2 ** step
    for p, g, m, v, w in zip(*(tree_leaves(t) for t in (
            params, grads, state["m"], state["v"], state["master"]))):
        g = g.to(F32) * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        denom = torch.div(v, c2).sqrt_().add_(cfg.eps)     # sqrt(vh) + eps
        w.mul_(1 - lr * cfg.weight_decay)                   # decay, then
        w.addcdiv_(m, denom, value=-lr / c1)                # - lr * mh / denom
        del denom
        p.copy_(w)                                          # in p's dtype
    state["step"].fill_(step)
    return params, state, gnorm
