"""Quickstart: build an assigned architecture, train a few steps, serve it
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch llama3.2-1b] [--device cuda]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = reduced(get_arch(args.arch))     # smoke-sized config, same family
    print(f"arch={cfg.name} family={cfg.family} "
          f"pattern={cfg.block_pattern[:4]}... on {device}")

    tcfg = TrainConfig(steps=args.steps, global_batch=8, seq_len=64,
                       log_every=10)
    losses, _, (params, _) = train(cfg, tcfg, device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    eng = Engine(cfg, params, ServeConfig(max_seq=96))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16))).to(device)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((2, cfg.enc_seq, cfg.d_model),
                                      device=device)
    if cfg.num_patch_tokens:
        batch["patches"] = torch.zeros((2, cfg.num_patch_tokens,
                                        cfg.d_model), device=device)
    toks = eng.generate(batch, 8)
    print("generated token ids:\n", toks.cpu().numpy())
    return losses, toks


if __name__ == "__main__":
    main()
