"""Production training driver (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        [--smoke] [--steps N] [--ckpt DIR] [--moe-overlap] [--sp-residuals] \\
        [--device cuda]

As in the reference, the arch's reduced config trains unless 256 ranks
are present (``--smoke`` forces it); then the full config trains on the
production mesh. Ranks are the CUDA devices (one on ``--device cpu``).
With two or more, a ``("data", "model")`` ``VirtualMesh`` of the
reference's shape takes the MoE layers' sharding; with one, there is no
mesh. Resumes automatically from ``--ckpt``; SIGTERM checkpoints and
exits cleanly (preemption-safe).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import StepOptions
from repro_torch.train import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-overlap", action="store_true")
    ap.add_argument("--moe-quantize", action="store_true")
    ap.add_argument("--sp-residuals", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    production = n_dev >= 256 and not args.smoke
    cfg = get_arch(args.arch) if production else reduced(get_arch(args.arch))
    mesh = None
    if production:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=device)
    elif n_dev >= 2:
        from repro_torch.launch.mesh import make_mesh
        model = 2 if n_dev % 2 == 0 else 1
        mesh = make_mesh((n_dev // model, model), ("data", "model"),
                         device=device)

    gb = args.global_batch or (256 if production else 8)
    sl = args.seq_len or (4096 if production else 128)
    opts = StepOptions(moe_overlap=args.moe_overlap,
                       moe_quantize=args.moe_quantize,
                       sp_residuals=args.sp_residuals,
                       loss_chunk=args.loss_chunk)
    tcfg = TrainConfig(steps=args.steps, global_batch=gb, seq_len=sl,
                       ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                       opts=opts)
    print(f"[launch] arch={cfg.name} devices={n_dev} "
          f"mesh={dict(mesh.shape) if mesh else None} batch={gb} seq={sl} "
          f"on {device}")
    losses, last, _ = train(cfg, tcfg, mesh=mesh, device=device)
    print(f"[launch] finished at step {last}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
