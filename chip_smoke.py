#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one H100:

    python3 chip_smoke.py

Phases (each a function a test can call with ``device="cpu"`` at tiny
sizes; every run runs all four, and any failure exits non-zero):

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — build the Hopper kernel from ``src/repro_torch/csrc`` and
   print ptxas's register / shared-memory / spill lines.
3. ``kernels`` — every moe_dispatch variant the main path runs
   (``kernels.moe_dispatch.VARIANTS``), on the inputs of the main path's
   two workloads (serving width and the skewed MoEDispatch shape): the
   kernel against its plain version on the same inputs (max-abs-normalised
   error within 1e-4 for the f32 wire, 1e-3 for the int8 wire), with the
   kernel's, the plain version's and the same GEMMs' ``torch.matmul`` time
   (CUDA events, warmed, L2 flushed before each launch) beside the bound.
4. ``main``    — the main path with every launch counter at 0:
   ``fast_path`` on ``ServingStep(n_dev=4)`` and ``MoEDispatch(n_dev=4)``
   (the seed must be the kernel's ``PALLAS_RDMA`` directive at level 3),
   then the same evaluator scores the Table-3 directives and three more;
   every one must reach level 3. The counters are read right after.

``--iters`` sets the timed launches per kernel (1 for a quick check after
a kernel change). The line before the last is the ``kernels`` JSON
record; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores (data sheet)
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3 (data sheet)
SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"
REPLACES = "src/repro/kernels/moe_dispatch.py:415"

def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ phases


def phase_device(device="cuda"):
    """Name the device; on a card also print nvidia-smi's name and power
    limit line. Returns the device description."""
    device = torch.device(device)
    if device.type != "cuda":
        log("device: cpu")
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    name = torch.cuda.get_device_name(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {name} x{torch.cuda.device_count()}, capability "
        f"{torch.cuda.get_device_capability(device)}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")
    for line in smi.splitlines():
        log(line)                     # name, power limit: as nvidia-smi says
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}


def phase_build(device="cuda"):
    """Build and load the kernel and print ptxas's resource lines and the
    co-resident grid of each launch shape."""
    from repro_torch.kernels import build, moe_dispatch
    if torch.device(device).type != "cuda":
        log("build: skipped on the cpu (kernels need nvcc and a card)")
        return
    t0 = time.perf_counter()
    lib = moe_dispatch.load_kernel()
    log(f"build: moe_dispatch in {time.perf_counter() - t0:.1f} s "
        f"({lib._name})")
    for line in build.ptxas_log("moe_dispatch"):
        log(f"ptxas: {line.strip()}")
    for shared in (False, True):
        for i8 in (False, True):
            grid, per_sm = moe_dispatch.grid_for(device, 4, shared, i8)
            log(f"grid: shared={shared} int8={i8}: {grid} CTAs "
                f"({per_sm} per SM)")


def time_ms(fn, device, iters, flush):
    """Mean ms of ``fn()``: CUDA events around each call after a warm-up,
    with the L2 overwritten before each call; host clock on the cpu."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / iters


def bound(w, counts):
    """Least time of one call of ``w``'s kernel on an H100: f32 operations
    over the f32 rate, or bytes (each input read once, each output written
    once) over HBM — whichever is larger. Routed rows are the tokens
    routed; T is their sum."""
    n, T, d, f = w.n_dev, sum(counts), w.d, w.f
    fs = w.f_shared if w.second_stream else 0
    flops = sum(6 * n * c * d * f for c in counts) + 6 * n * T * d * fs
    elems = n * T * d + n * d * 2 * f + n * f * d + n * T * d
    if fs:
        elems += d * 2 * fs + fs * d + n * T * d
    t_ops, t_bytes = flops / F32_FLOPS, 4 * elems / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops


def phase_kernels(device="cuda", workloads=None, iters=5):
    """Hold every variant against its plain version on each workload's
    inputs. Returns one record per (variant, workload) for the ``kernels``
    line, keyed by ``_key``; ``main`` fills in ``launches``."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels.moe_dispatch import (VARIANTS,
                                                  moe_dispatch_combine,
                                                  moe_dispatch_combine_ref,
                                                  variant_name)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device) \
        if torch.device(device).type == "cuda" else None
    out = []
    for w in workloads or main_path_workloads():
        ins = w.example_inputs(0, VirtualMesh(w.n_dev, device=device))
        x, w1, w2 = ins[:3]
        shared = (x, *ins[3:]) if w.second_stream else None
        n, T, d = x.shape
        f, fs = w.f, (w.f_shared if shared else 0)
        counts = [int(c) for c in w._counts(T)]
        b_ms, b_by, flops = bound(w, counts)
        offs = [sum(counts[:e]) for e in range(n)]

        def library():
            # the same routed and shared GEMMs as one torch.matmul each
            for e in range(n):
                h = torch.matmul(x[:, offs[e]:offs[e] + counts[e]], w1[e])
                torch.matmul(h[..., :f], w2[e])
            if shared is not None:
                h = torch.matmul(x, shared[1])
                torch.matmul(h[..., :fs], shared[2])

        lib_ms = time_ms(library, device, iters, flush)
        for knobs in VARIANTS.values():
            wire_i8 = knobs.get("wire_i8", False)
            kw = dict(counts=counts, block_tokens=64, tight=True, **knobs)
            with torch.no_grad():
                got = moe_dispatch_combine(x, w1, w2, shared=shared, **kw)
                want = moe_dispatch_combine_ref(
                    x, w1, w2, counts=counts, block_tokens=64, tight=True,
                    wire_i8=wire_i8, shared=shared)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            rel = max(float((a - b).abs().max() / (b.abs().max() + 1e-9))
                      for a, b in zip(got, want))
            tol = 1e-3 if wire_i8 else 1e-4
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            ok = finite and rel <= tol
            k_ms = time_ms(lambda: moe_dispatch_combine(x, w1, w2, shared=shared,
                                                        **kw),
                           device, iters, flush)
            p_ms = time_ms(lambda: moe_dispatch_combine_ref(
                x, w1, w2, counts=counts, block_tokens=64, tight=True,
                wire_i8=wire_i8, shared=shared), device, iters, flush)
            key = variant_name(
                barrier=knobs.get("barrier", False),
                pipelined=knobs.get("pipelined", True),
                tile_fused=knobs.get("tile_fused", False), wire_i8=wire_i8,
                shared=shared is not None,
                combine_tile=knobs.get("combine_tile"), block_tokens=64)
            log(f"kernel {key} @{w.name} n={n} T={T} d={d} f={f} fs={fs} "
                f"counts={counts}: rel err {rel:.3e} (tol {tol:.0e}), "
                f"max abs err {abs_err:.3e}; kernel {k_ms:.3f} ms, "
                f"plain {p_ms:.3f} ms, matmul {lib_ms:.3f} ms, bound "
                f"{b_ms:.3f} ms by {b_by} ({flops / 1e9:.1f} GFLOP) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"kernel {key} @{w.name} disagrees with its "
                                 f"plain version: rel err {rel:.3e} > {tol:.0e}"
                                 f" (finite={finite})")
            out.append({"name": f"moe_dispatch/{key}@{w.name}", "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": None, "max_abs_err": abs_err, "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms,
                        "_key": (key, n, T, d, f)})
        del x, w1, w2, shared, ins
    return out


def main_path_workloads(small=False):
    """The slice's two workloads at their defaults (``small``: test size)."""
    from repro_torch.workloads.moe_dispatch import MoEDispatch
    from repro_torch.workloads.serving import ServingStep
    if small:
        return [ServingStep(n_dev=4, tokens_per_rank=64, d=64, f=64,
                            f_shared=64),
                MoEDispatch(n_dev=4, tokens_per_rank=256, d=64, f=128)]
    return [ServingStep(n_dev=4), MoEDispatch(n_dev=4)]


def main_path_directives():
    """Table 3's points plus the three that reach the kernel's other
    branches: per-source pipelined SIGNAL, FLUX on the int8 wire, FLUX with
    16-row combine tiles."""
    from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
    flux = EXPERT_SYSTEMS["FLUX"]
    return dict(EXPERT_SYSTEMS, **{
        "DeepEP pipelined": Directive("PALLAS_RDMA", "SIGNAL",
                                      "TILE_PIPELINED", "LOCAL", "GRID_STEP",
                                      "PER_PEER", "ACQUIRE", 2),
        "FLUX int8": flux.with_tunable("wire_i8", 1),
        "FLUX ct16": flux.with_tunable("combine_tile", 16),
    })


def phase_main(device="cuda", workloads=None):
    """The main path, counted: fast_path then the directives through the
    same evaluator, for each workload. Returns the launch counter."""
    from repro_torch.core.cascade import Candidate, CascadeEvaluator
    from repro_torch.core.design_space import directive_key
    from repro_torch.core.fast_path import fast_path
    from repro_torch.core.hardware import H100, extract_hardware_context
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import moe_dispatch as kern
    kern.reset_launches()
    for w in workloads or main_path_workloads():
        mesh = VirtualMesh(w.n_dev, device=device)
        hw = extract_hardware_context(mesh, H100)
        log(f"context {w.name}: {hw.topology_summary}; device "
            f"{hw.device_name or mesh.device} ({hw.sm_count} SMs)")
        ev = CascadeEvaluator(w, mesh, hw, wallclock=True)
        before = kern.launches()
        t0 = time.perf_counter()
        seed = fast_path(w, mesh, hw, evaluator=ev)
        res = seed.candidate.result
        log(f"fast_path {w.name}: {seed.directive.backend} level {res.level} "
            f"score {res.score:.2f} in {time.perf_counter() - t0:.1f} s; "
            f"kernel launches {kern.launches() - before}")
        for line in seed.log:
            log(f"  {line}")
        if seed.directive.backend != "PALLAS_RDMA" or res.level != 3:
            raise SystemExit(f"fast path on {w.name} fell back to "
                             f"{seed.directive.backend}")
        if torch.device(device).type == "cuda" and kern.launches() == before:
            raise SystemExit(f"fast path on {w.name} launched no kernel")
        for name, d in main_path_directives().items():
            r = ev.evaluate(Candidate(d, mutation=name))
            log(f"cascade {w.name} {name}: level {r.level} score "
                f"{r.score:.3f} t_model_ms {r.t_model_ms:.4f} (H100 model) "
                f"t_wall_ms {r.t_wall_ms:.4f} ({ev.device}) "
                f"key {directive_key(d)}")
            if r.level != 3:
                raise SystemExit(f"{name} on {w.name} stopped at level "
                                 f"{r.level}: {r.diagnostic}")
    return dict(kern.LAUNCHES)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5,
                    help="timed launches per kernel and plain version")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device("cuda")
    phase_build("cuda")
    records = phase_kernels("cuda", iters=args.iters)
    counts = phase_main("cuda")
    log(f"launches on the main path: {counts}")
    for rec in records:
        rec["launches"] = counts.get(rec.pop("_key"), 0)
        if rec["launches"] == 0:
            raise SystemExit(f"{rec['name']} was not launched on the "
                             "main path")
    log(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
