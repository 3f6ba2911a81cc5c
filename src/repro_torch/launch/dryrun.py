"""Dry run: count every (arch x shape x mesh) cell's step and derive its
roofline terms (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 placeholder devices
and reads the compiled module. The port traces the torch step itself on
the meta device (``core/op_count.py``: no memory, no number, any size) on
the production ``VirtualMesh`` (``launch/mesh.py``, also on meta), so it
runs on any machine:

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--jobs 4]

Artifacts are JSON with the reference's keys (``launch/report.py`` of
either package renders them), in ``artifacts/dryrun_torch/``. The port's
program differs from the reference's by design: it partitions no dense
op (each runs whole, once), so per-device FLOPs and bytes are the whole
program's divided by the ranks, and its only collectives are those the
program runs (the MoE layers'); ``convert_overhead`` is 0
(``core/cost_model.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

from repro_torch.configs import cells, get_arch, get_shape
from repro_torch.core.cost_model import roofline_from_count
from repro_torch.core.hardware import extract_hardware_context
from repro_torch.core.op_count import op_count
from repro_torch.dist.sharding import P, sanitize_specs, tree_leaves, tree_map
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SDS, input_specs, rules_for, stand_ins
from repro_torch.models import StepOptions, cache_specs
from repro_torch.models.model import ShapeDtype

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" \
    / "dryrun_torch"


def _shards(spec, mesh):
    """How many ways ``spec`` cuts a leaf on ``mesh``."""
    n = 1
    for entry in spec:
        if entry is not None:
            n *= mesh.size(entry)
    return n


def device_bytes(sds, specs, mesh):
    """Bytes of one device's shards of a :class:`ShapeDtype` tree (or a
    tuple of them) under its spec tree: each leaf's bytes divided by its
    shard count."""
    if isinstance(sds, tuple) and not isinstance(sds, ShapeDtype):
        return sum(device_bytes(s, sp, mesh) for s, sp in zip(sds, specs))
    per = tree_map(lambda s, sp: math.prod(s.shape) * s.dtype.itemsize
                   // _shards(sp, mesh), sds, specs)
    return sum(tree_leaves(per))


def _outputs(cfg, shape, rules, mesh, in_sds, in_specs):
    """Per-device bytes of the step's outputs, and of those aliasing a
    donated argument: train returns the parameters and optimizer state
    (donated) and two f32 scalars; prefill the last position's f32 logits
    (sharded as the batch) and a new cache; decode the logits and the
    cache it was given (donated)."""
    if shape.kind == "train":
        kept = device_bytes(in_sds[:2], in_specs[:2], mesh)
        return kept + 8, kept
    b = in_specs[-1]["tokens"][0] if shape.kind == "prefill" \
        else in_specs[2][0]
    logits = device_bytes(SDS((shape.global_batch, 1, cfg.vocab_padded),
                              torch.float32), P(b, None, None), mesh)
    if shape.kind == "prefill":
        c_sds, c_specs = cache_specs(cfg, shape.global_batch, shape.seq_len,
                                     rules)
        return logits + device_bytes(c_sds, sanitize_specs(
            c_specs, c_sds, mesh), mesh), 0
    cache = device_bytes(in_sds[1], in_specs[1], mesh)
    return logits + cache, cache


def run_cell(arch: str, shape_name: str, multi_pod: bool, opts_kw=None,
             mesh=None, verbose=True):
    """Three-trace dry run for one cell.

    Cost and collectives: the step traced at depth R=1 (one repeat unit)
    and R=2 and extrapolated linearly, as the reference does:
    per_layer = cost(R2) - cost(R1); total = cost(R1) + (R_full-1) *
    per_layer. The R1 trace carries everything outside the layer stack
    (embeddings, loss, the optimizer's work on the shared parameters)
    once, so the extrapolation is exact for layer-homogeneous models
    (``tests/test_torch_dryrun.py`` checks it against a full-depth trace).

    Memory: argument bytes per device from the specs (each leaf's bytes
    over its shard count); output and alias bytes from the step's
    donation; temp bytes the full-depth trace's peak live bytes (every
    storage the step makes, the arguments not included) over the ranks.
    """
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name,
                "skipped": "full-attention arch: needs sub-quadratic attention"}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    hw = extract_hardware_context(mesh)
    base_kw = dict(flash_threshold=2048, loss_chunk=512)
    base_kw.update(opts_kw or {})
    opts = StepOptions(**base_kw)
    if opts.moe_backend != "xla" or mesh.device.type != "meta":
        raise ValueError(
            f"the dry run traces on the meta device with the xla MoE body "
            f"(got moe_backend={opts.moe_backend!r} on {mesh.device}): a "
            "hand-written kernel cannot run on meta")
    t0 = time.time()

    def trace(c):
        fn, in_sds, _, _ = input_specs(c, shape, mesh, opts)
        with op_count() as count:
            fn(*stand_ins(in_sds))
        return roofline_from_count(count, mesh, hw.chip), count.peak_bytes

    unit = cfg.repeat_unit
    R = cfg.num_repeats
    enc_per = (cfg.enc_layers // R) if cfg.is_encoder_decoder else 0

    def depth_cfg(k):
        kw = {"num_layers": k * unit}
        if cfg.is_encoder_decoder:
            kw["enc_layers"] = k * enc_per
        return dataclasses.replace(cfg, **kw)

    rep1, peak = trace(depth_cfg(1))
    if R > 1:
        rep2, _ = trace(depth_cfg(2))
        rep = rep1.extrapolate(rep2, R)
        _, peak = trace(cfg)
    else:
        rep = rep1
    t_compile = time.time() - t0
    t_lower = 0.0
    _, in_sds, in_specs, _ = input_specs(cfg, shape, mesh, opts)
    arg_b = device_bytes(in_sds, in_specs, mesh)
    out_b, alias_b = _outputs(cfg, shape, rules_for(mesh, shape), mesh,
                              in_sds, in_specs)
    tmp_b = peak // hw.n_chips
    if verbose:
        print({"argument_bytes": arg_b, "output_bytes": out_b,
               "temp_bytes": tmp_b, "alias_bytes": alias_b})
        print({"flops": rep.flops, "bytes accessed": rep.bytes_accessed})

    # useful-FLOPs ratio: 6*N_active*D train, 2*N_active*D prefill/decode
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    per_dev_model_flops = model_flops / hw.n_chips
    peak_b = arg_b + tmp_b + max(0, out_b - alias_b)
    # Analytic activation estimate (the reference's): remat residuals per
    # layer + working set.
    dp = max(1, min(hw.n_chips // 16, shape.global_batch))
    B_l = max(1, shape.global_batch // dp)
    S = shape.seq_len if shape.kind != "decode" else 1
    d = cfg.d_model
    resid = cfg.num_layers * B_l * S * d * 2 if shape.kind == "train" else 0
    if base_kw.get("sp_residuals"):
        resid //= 16                     # remat carries sequence-sharded (TP)
    work = 8 * B_l * S * d * 4
    analytic = arg_b + resid + work
    # corrected memory term floored at one full read of the live arguments
    # (weights + cache must cross HBM at least once per step on any target)
    summ = rep.summary()
    summ["memory_corrected_s"] = max(
        summ["memory_corrected_s"], arg_b / hw.chip.hbm_bw)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in hw.mesh_shape),
        "n_chips": hw.n_chips,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": tmp_b, "alias_bytes": alias_b,
                   "peak_bytes": peak_b,
                   "analytic_peak_bytes": int(analytic),
                   "fits_hbm": bool(peak_b <= hw.chip.hbm_bytes),
                   "fits_hbm_analytic": bool(analytic <= hw.chip.hbm_bytes)},
        "roofline": summ,
        "model_flops": model_flops,
        "useful_flops_ratio": (per_dev_model_flops / rep.flops
                               if rep.flops else 0.0),
        "collective_schedule": [c.describe() for c in sorted(
            rep.collectives, key=lambda c: -c.wire_bytes)[:20]],
    }
    if verbose:
        print(json.dumps({k: result[k] for k in
                          ("arch", "shape", "mesh", "roofline",
                           "useful_flops_ratio")}, indent=1, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--moe-overlap", action="store_true")
    ap.add_argument("--moe-quantize", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--kv-block", type=int, default=1024)
    ap.add_argument("--flash-threshold", type=int, default=8192)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--sp-residuals", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=512)
    args = ap.parse_args(argv)

    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    if args.all:
        jobs = []
        for a, s, skip in cells():
            for mp in (False, True):
                tag = f"{a}__{s}__{'multi' if mp else 'single'}"
                out = ARTIFACTS / f"{tag}.json"
                if out.exists():
                    continue
                if skip:
                    out.write_text(json.dumps(
                        {"arch": a, "shape": s, "skipped": skip}))
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", a, "--shape", s, "--out", str(out)]
                if mp:
                    cmd.append("--multi-pod")
                jobs.append((tag, cmd))
        running = []
        while jobs or running:
            while jobs and len(running) < args.jobs:
                tag, cmd = jobs.pop(0)
                print("START", tag, flush=True)
                running.append((tag, subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
            for tag, proc in list(running):
                if proc.poll() is not None:
                    running.remove((tag, proc))
                    status = "OK" if proc.returncode == 0 else "FAIL"
                    print(f"DONE {tag}: {status}", flush=True)
                    if proc.returncode != 0:
                        err = proc.stderr.read().decode()[-2000:]
                        (ARTIFACTS / f"{tag}.err").write_text(err)
            time.sleep(2)
        return

    opts_kw = dict(moe_overlap=args.moe_overlap, moe_quantize=args.moe_quantize,
                   remat=not args.no_remat, kv_block=args.kv_block,
                   flash_threshold=args.flash_threshold,
                   seq_parallel=args.seq_parallel,
                   sp_residuals=args.sp_residuals, loss_chunk=args.loss_chunk)
    res = run_cell(args.arch, args.shape, args.multi_pod, opts_kw)
    out = pathlib.Path(args.out) if args.out else \
        ARTIFACTS / f"{args.arch}__{args.shape}__" \
        f"{'multi' if args.multi_pod else 'single'}.json"
    out.write_text(json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
