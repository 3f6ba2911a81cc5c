"""Time a config's training step on a device, as the dry run builds it
(``launch/specs.py::make_train_step``: the loss, its gradients under
remat, AdamW in place), from random weights drawn from seed 0:

  python -m repro_torch.launch.step_time --arch xlstm-350m --seq 2048 \\
      --batch 4 [--device cuda]

Prints one JSON line: the config, the median of 3 steps after a warm-up
and each of them (ms, host clock after a synchronize),
``max_memory_allocated`` over the warm-up and the timed steps (bytes, on
a card) and the card's name and power limit. Uses only modules the port
has had since its trainer, so the same file times an earlier tree (copy
it into that tree's ``launch/`` and run it there).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.hardware import card_label
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.specs import make_train_step
from repro_torch.models import StepOptions
from repro_torch.optim import AdamWConfig
from repro_torch.train import build_state
from repro_torch.train.loop import device_batch


def step_time(cfg, seq, batch, steps=3, device="cuda"):
    """The record :func:`main` prints for ``cfg`` (see the module's
    docstring), over ``steps`` timed steps."""
    params, opt_state = build_state(torch.Generator(
        device=device).manual_seed(0), cfg, None, None, device)[:2]
    tokens = {k: v.to(torch.int32) for k, v in device_batch(
        SyntheticTokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq,
            global_batch=batch)).batch(0), device).items()}
    fn = make_train_step(cfg, None, StepOptions(), AdamWConfig())
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats(device)
    fn(params, opt_state, tokens)
    sync()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn(params, opt_state, tokens)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
            "seq": seq, "ms": statistics.median(times), "times_ms": times,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                     if cuda else None),
            "card": card_label(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(step_time(get_arch(args.arch), args.seq, args.batch,
                               device=args.device)), flush=True)


if __name__ == "__main__":
    main()
