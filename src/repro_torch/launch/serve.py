"""Serving entry point: batched generation with a KV cache, optionally with a
disaggregated prefill/decode handoff (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        [--batch 8] [--prompt-len 64] [--new-tokens 64] [--disaggregated] \\
        [--no-smoke] [--moe-backend {xla,pallas}] [--moe-overlap] [--ep N] \\
        [--device cuda]

Every architecture of ``repro_torch.configs`` serves: attention (dense
and MoE), xLSTM and RecurrentGemma, and whisper, whose encoder reads
``frames`` (B, enc_seq, d_model) drawn from a seeded generator on the
device (the reference's conv front end is a stub there too). Weights are
random, from seed 0. ``--smoke`` (the default, as in the reference) serves
the architecture's reduced test size; ``--no-smoke`` its published
widths. A MoE architecture reaches the ``moe_dispatch.cu``
kernel with ``--ep N`` (a ``VirtualMesh(N)`` data mesh: the batch and the
experts shard over N ranks of the card) and ``--moe-backend pallas``;
``--moe-overlap`` runs the shared expert as the kernel's second stream.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import Rules
from repro_torch.models import StepOptions, init_params
from repro_torch.serve import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--disaggregated", action="store_true")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--moe-backend", choices=("xla", "pallas"),
                    default="xla")
    ap.add_argument("--moe-overlap", action="store_true")
    ap.add_argument("--ep", type=int, default=0,
                    help="data ranks of a VirtualMesh for the MoE layers "
                         "(0: no mesh)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch)) if args.smoke else get_arch(args.arch)
    device = torch.device(args.device)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    rules = Rules(VirtualMesh(args.ep, device=device, axis="data"),
                  "decode") if args.ep else None
    opts = StepOptions(moe_backend=args.moe_backend,
                       moe_overlap=args.moe_overlap)
    eng = Engine(cfg, params, ServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 1,
        temperature=args.temperature, opts=opts), rules=rules)

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(1))
    if cfg.num_patch_tokens:
        batch["patches"] = torch.zeros(
            (args.batch, cfg.num_patch_tokens, cfg.d_model), device=device)

    t0 = time.perf_counter()
    if args.disaggregated:
        handoff = eng.prefill_remote(batch)      # prefill tier
        toks = eng.decode_from_handoff(handoff, args.new_tokens)
    else:
        toks = eng.generate(batch, args.new_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = args.batch * args.new_tokens
    print(f"[serve] {cfg.name} on {device}: {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. kernel builds); "
          f"mode={'disaggregated' if args.disaggregated else 'monolithic'}, "
          f"moe_backend={args.moe_backend}, ep={args.ep}")
    print("[serve] sample:", toks[0][:16].tolist())


if __name__ == "__main__":
    main()
