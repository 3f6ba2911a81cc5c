"""End to end: train a ~100M-parameter MoE LM for a few hundred steps
with sharded execution, checkpointing, preemption-safe restart, and the CUCo
MoE overlap schedule enabled (port of ``examples/train_moe_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_moe_100m --steps 300 [--device cuda]

The reference runs 4-way data x 2-way model parallel on 8 devices; here
the MoE layers run on a ``VirtualMesh`` of that shape on the one device.
"""
import argparse
from pathlib import Path

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import StepOptions
from repro_torch.train import TrainConfig, train


# checkpoints in the checkout's build directory
CKPT = Path(__file__).resolve().parents[3] / "build" / "repro_torch" \
    / "moe_100m"


def config():
    """~100M params: granite-moe family scaled between smoke and full size."""
    return reduced(
        get_arch("granite-moe-3b-a800m"),
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1024, moe_d_ff=1024, num_experts=8, experts_per_token=2,
        vocab_size=32000, pad_to=2, name="granite-moe-100m")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = config()
    n_est = cfg.param_count()
    print(f"model: {cfg.name}, ~{n_est / 1e6:.0f}M params (analytic)")

    mesh = make_mesh((4, 2), ("data", "model"), device=device)
    print("mesh:", dict(mesh.shape), "on", device)

    tcfg = TrainConfig(
        steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt, ckpt_every=100, log_every=20,
        opts=StepOptions(moe_overlap=True))      # CUCo self/remote split
    losses, last, _ = train(cfg, tcfg, mesh=mesh, device=device)
    print(f"trained to step {last}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"checkpoints in {args.ckpt} — re-run to resume, SIGTERM to "
          "preempt gracefully")
    return losses, last


if __name__ == "__main__":
    main()
