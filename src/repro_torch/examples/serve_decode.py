"""Serve a small model with batched requests + disaggregated prefill/decode
(port of ``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch llama3.2-1b [--device cuda]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import init_params
from repro_torch.serve import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = reduced(get_arch(args.arch))
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    eng = Engine(cfg, params,
                 ServeConfig(max_seq=args.prompt_len + args.new_tokens + 1))

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                                      device=device)
    if cfg.num_patch_tokens:
        batch["patches"] = torch.zeros(
            (args.batch, cfg.num_patch_tokens, cfg.d_model), device=device)

    t0 = time.perf_counter()
    toks = eng.generate(batch, args.new_tokens)
    dt = time.perf_counter() - t0
    total = args.batch * args.new_tokens
    print(f"monolithic: {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. first-call set-up) on {device}")

    # disaggregated: prefill tier -> cache handoff -> decode tier
    handoff = eng.prefill_remote(batch)
    toks2 = eng.decode_from_handoff(handoff, args.new_tokens)
    same = torch.equal(toks, toks2)
    print(f"disaggregated prefill/decode equals monolithic: {same}")
    print("sample output ids:", toks[0][:12].cpu().numpy())
    return toks, toks2


if __name__ == "__main__":
    main()
