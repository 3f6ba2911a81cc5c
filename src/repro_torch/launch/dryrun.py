"""Dry run: count every (arch x shape x mesh) cell's step and derive its
roofline terms (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 placeholder devices
and reads the compiled module. The port traces the torch step itself on
the meta device (``core/op_count.py``: no memory, no number, any size) on
the production ``VirtualMesh`` (``launch/mesh.py``, also on meta), so it
runs on any machine:

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--jobs 4]

A train or prefill cell over xLSTM's stack, whose sLSTM loops over
tokens, is counted from short traces scaled in the loops' trip counts
(:func:`scaled_count`).

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
from repro_torch.core.op_count import OpCount, op_count
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


TOKEN_LOOP_KINDS = ("mlstm", "slstm")


def loops_over_tokens(cfg, shape):
    """True where a cell takes :func:`scaled_count`: a train or prefill
    step over a stack whose every block loops over tokens (sLSTM) or
    chunks (mLSTM), at a length of whole chunks, at least three."""
    W = cfg.mlstm_chunk
    return (shape.kind in ("train", "prefill")
            and all(k in TOKEN_LOOP_KINDS for k in cfg.block_pattern)
            and shape.seq_len % W == 0 and shape.seq_len >= 3 * W)


def _depth(cfg, k):
    """``cfg`` with ``k`` repeat units (0: no layer stack)."""
    kw = {"num_layers": k * cfg.repeat_unit}
    if cfg.is_encoder_decoder:
        kw["enc_layers"] = k * (cfg.enc_layers // cfg.num_repeats)
    return dataclasses.replace(cfg, **kw)


def _trace(cfg, shape, mesh, opts, sites=False):
    fn, in_sds, _, _ = input_specs(cfg, shape, mesh, opts)
    with op_count(sites=sites) as count:
        fn(*stand_ins(in_sds))
    return count


def scaled_count(cfg, shape, mesh, opts):
    """The count of ``shape``'s step over ``cfg``'s R repeat units, from
    traces whose loops run few times: the loops' trip counts scale as the
    dry run scales depth. Returns ``(OpCount, traces)``: FLOPs, bytes,
    ops and peak live bytes, and the number of traces taken.

    On meta a step's ops depend on its trip counts only. With c(k, S)
    the trace at k repeat units and length S, two short lengths S1 < S2
    (two and three chunks: with one, the first chunk is also the last and
    carries no state on) and two depths a, a + 1 (below):

      count(R, S) = c(0, S) + l(a) - l(0) + (R - a) (l(a + 1) - l(a)),

    l(k) the count at k units taken at S1 and S2 and extended to S in a
    straight line: every term of a unit's count is affine in S. c(0, S)
    (no layer stack: embedding, loss, optimizer) walks no token and is
    traced at S itself, so what the outside does only at S (the loss
    over sequence chunks once S passes ``loss_chunk``) is counted as it
    runs. FLOPs, bytes and ops are exact integers; a step that records a
    collective or launches a kernel is refused.

    Peak live bytes is the largest over allocation sites
    (``op_count(sites=True)``) of each site's peak at (R, S). A site of
    the units (none without a stack) is bilinear in (R, S) from its peaks
    at a and a + 1 units at S1 and S2. A site of the outside has its
    peak in c(0, S) plus what the units add there (bilinear in the same
    way); a site only c(0, S) has (the chunked loss) adds what the units
    add at the sites only S1 and S2 have (the unchunked loss), which
    must agree. a is 1 for a train step under remat, which keeps every
    unit's input until its backward, and 2 otherwise: there the first
    unit's input (the embedding, which the forward holds anyway) costs
    nothing more, so one unit is not a repeat of the others. This is
    exact as long as each site peaks at the same iteration of its loops
    (the first or the last) at S1, S2 and S:
    ``tests/test_torch_dryrun_xlstm.py`` holds the scaled count to a full
    trace at held-out lengths and depths."""
    W = cfg.mlstm_chunk
    S, R = shape.seq_len, cfg.num_repeats
    S1, S2 = 2 * W, 3 * W
    a = 1 if shape.kind == "train" and opts.remat else 2
    if S % W or S < S2 or R < a:
        raise ValueError(f"scaled count: a length of whole chunks of {W}, "
                         f"at least {S2}, and {a} or more repeat units "
                         f"(got {S} and {R})")
    k = (S - S1) // W
    full0 = _trace(_depth(cfg, 0), shape, mesh, opts, True)
    c = {(d, s): _trace(_depth(cfg, d), dataclasses.replace(shape,
                                                            seq_len=s),
                        mesh, opts, True)
         for d in (0, a, a + 1) for s in (S1, S2)}
    for cnt in (full0, *c.values()):
        if cnt.events or cnt.opaque:
            raise ValueError("scaled count: the step records collectives or "
                             "launches kernels; trace it whole")

    def line(f, d):
        """f at d units, extended from S1 and S2 to S."""
        return f(d, S1) + k * (f(d, S2) - f(d, S1))

    def bilinear(f):
        """f(units, length) at (R, S) from a and a + 1 units."""
        return line(f, a) + (R - a) * (line(f, a + 1) - line(f, a))

    def total(attr):
        def f(d, s):
            return getattr(c[d, s], attr)
        return getattr(full0, attr) + bilinear(f) - line(f, 0)

    sp = {key: cnt.site_peaks for key, cnt in c.items()}
    short = set.intersection(*(set(p) for p in sp.values()))
    units = set.intersection(*(set(sp[d, s]) for d in (a, a + 1)
                               for s in (S1, S2))) - set(sp[0, S1]) \
        - set(sp[0, S2])

    def added(key):
        return bilinear(lambda d, s: sp[d, s][key] - sp[0, s][key])
    peaks = [bilinear(lambda d, s: sp[d, s][key]) for key in units]
    regime = {added(key) for key in short - set(full0.site_peaks)}
    for key, v in full0.site_peaks.items():
        if key in short:
            peaks.append(v + added(key))
        elif len(regime) == 1:
            peaks.append(v + next(iter(regime)))
        else:
            raise ValueError("scaled count: a site of the step at "
                             f"{S} tokens has no counterpart at {S1} and "
                             f"{S2} ({len(regime)} additions)")
    count = OpCount(flops=total("flops"), bytes=total("bytes"),
                    ops=total("ops"), peak_bytes=max(peaks))
    return count, 1 + len(c)


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

    A train or prefill cell over a stack that loops over tokens (xLSTM:
    :func:`loops_over_tokens`) would walk every token in each of those
    traces; it takes :func:`scaled_count` instead, which scales short
    traces in the loops' trip counts as well as in depth. Its FLOPs, bytes and peak equal a full trace's
    (``tests/test_torch_dryrun_xlstm.py``).
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
        count = _trace(c, shape, mesh, opts)
        return roofline_from_count(count, mesh, hw.chip), count.peak_bytes

    R = cfg.num_repeats
    if loops_over_tokens(cfg, shape):
        count, _ = scaled_count(cfg, shape, mesh, opts)
        rep, peak = roofline_from_count(count, mesh, hw.chip), \
            count.peak_bytes
    elif R > 1:
        rep1, _ = trace(_depth(cfg, 1))
        rep2, _ = trace(_depth(cfg, 2))
        rep = rep1.extrapolate(rep2, R)
        _, peak = trace(cfg)
    else:
        rep, peak = trace(cfg)
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
