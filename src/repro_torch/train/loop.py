"""Training loop: a step + checkpoint/restart + preemption + straggler
watchdog (port of ``repro/train/loop.py``). The same loop drives the smoke
tests and the ``train`` phase of ``chip_smoke.py``.

A step is the reference's jitted ``step_fn`` in eager torch: the loss and
its gradient tree (:func:`loss_and_grads`, autograd where the reference
takes ``jax.value_and_grad``), then :func:`repro_torch.optim.adamw_update`
in place. With a mesh, ``Rules(mesh, "train")`` reaches the MoE layers,
whose bodies run per rank on the ``VirtualMesh`` and carry gradients
through its collectives; every other operator is the same computation on
one device whatever the sharding. Every tensor of the state lives on
``device`` (the optimizer's step counter on the host). No step is caught
and retried: a failed step raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core.telemetry import MetricsRegistry
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.dist.sharding import (Rules, sanitize_specs, tree_leaves,
                                       tree_map)
from repro_torch.models import StepOptions, init_params, param_specs, \
    train_loss
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state, \
    opt_state_specs
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.fault_tolerance import PreemptionGuard, \
    StragglerWatchdog


@dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    opts: StepOptions = field(default_factory=StepOptions)
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def build_state(gen, cfg, mesh, rules, device="cuda"):
    """Parameters from the ``torch.Generator`` ``gen`` and their optimizer
    state on ``device``; with a mesh also the parameters' specs under
    ``rules`` (divisibility-checked) and the optimizer state's (ZeRO).
    Returns ``(params, opt_state, specs, opt_specs)``."""
    params = init_params(gen, cfg, device=device)
    opt_state = init_opt_state(params)
    if mesh is None:
        return params, opt_state, None, None
    specs = sanitize_specs(param_specs(cfg, rules), params, mesh)
    return params, opt_state, specs, opt_state_specs(specs, params, rules)


def loss_and_grads(params, batch, cfg, rules=None, opts=None):
    """``train_loss`` and its gradient with respect to every leaf of
    ``params`` (``jax.value_and_grad``): ``(loss, grads)``, grads in the
    params' nesting and dtypes (zeros for a leaf the loss does not read).
    ``params`` are read only: the graph runs through detached aliases."""
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(alias)
    with torch.enable_grad():
        loss = train_loss(alias, batch, cfg, rules, opts)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def device_batch(batch, device):
    """A pipeline batch (numpy) on ``device``: token ids and labels as
    int64, the stub inputs as they are."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long
                                      if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def train(cfg, tcfg: TrainConfig, mesh=None, *, resume=True, verbose=True,
          max_steps_this_run=None, device="cuda", metrics=None):
    """Returns (losses, last_step, (params, opt_state)). Interruptible +
    resumable: resumes from the latest checkpoint in ``tcfg.ckpt_dir``,
    saves every ``ckpt_every`` steps, at the last step and when SIGTERM or
    SIGINT asks (then returns). ``mesh``: a ``VirtualMesh`` (or None).
    ``metrics`` (a ``core.telemetry.MetricsRegistry``, one of its own
    otherwise) gets each step's ``train.step_ms`` (host clock, the device
    synchronized), ``train.loss`` and ``train.gnorm``, and each save's
    ``train.ckpt_save_s``."""
    device = torch.device(device)
    metrics = metrics if metrics is not None else MetricsRegistry()
    rules = Rules(mesh, "train") if mesh is not None else None
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params, opt_state, _, _ = build_state(gen, cfg, mesh, rules, device)

    start = 0
    if resume and tcfg.ckpt_dir:
        restored, step = restore_checkpoint(
            tcfg.ckpt_dir, {"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = step
            if verbose:
                print(f"[train] resumed from step {start}")

    data = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
        global_batch=tcfg.global_batch, seed=tcfg.seed,
        frames=cfg.enc_seq if cfg.is_encoder_decoder else 0,
        patches=cfg.num_patch_tokens, d_model=cfg.d_model))
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    losses = []
    watchdog = StragglerWatchdog()
    end = tcfg.steps if max_steps_this_run is None else \
        min(tcfg.steps, start + max_steps_this_run)
    with PreemptionGuard() as guard:
        for step in range(start, end):
            t0 = time.perf_counter()
            batch = device_batch(data.batch(step), device)
            loss, grads = loss_and_grads(params, batch, cfg, rules,
                                         tcfg.opts)
            params, opt_state, gnorm = adamw_update(params, grads,
                                                    opt_state, tcfg.opt)
            del grads
            sync()
            dt = time.perf_counter() - t0
            loss, gnorm = float(loss), float(gnorm)
            losses.append(loss)
            watchdog.record(dt)
            metrics.histogram("train.step_ms").observe(dt * 1e3)
            metrics.histogram("train.loss").observe(loss)
            metrics.histogram("train.gnorm").observe(gnorm)
            if verbose and (step % tcfg.log_every == 0):
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {gnorm:.3f}")
            done = step + 1
            if tcfg.ckpt_dir and (done % tcfg.ckpt_every == 0
                                  or done == tcfg.steps or guard.requested):
                t0 = time.perf_counter()
                save_checkpoint(tcfg.ckpt_dir, done,
                                {"params": params, "opt": opt_state})
                metrics.histogram("train.ckpt_save_s").observe(
                    time.perf_counter() - t0)
            if guard.requested:
                if verbose:
                    print(f"[train] preemption requested — saved at {done}")
                break
    return losses, (step + 1 if losses else start), (params, opt_state)
