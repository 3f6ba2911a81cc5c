#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one H100:

    python3 chip_smoke.py

Phases (each a function a test can call with ``device="cpu"`` at tiny
sizes; every run runs all of them, and any failure exits non-zero):

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — build both Hopper kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together) and print ptxas's
   register / shared-memory / spill lines and each launch's grid.
3. ``kernels`` — every moe_dispatch variant the main path runs
   (``kernels.moe_dispatch.VARIANTS``), on the inputs of the main path's
   two workloads (serving width and the skewed MoEDispatch shape): the
   kernel against its plain version on the same inputs (max-abs-normalised
   error within 1e-4 for the f32 wire, 1e-3 for the int8 wire), with the
   kernel's, the plain version's and the same GEMMs' ``torch.matmul`` time
   (CUDA events, warmed, L2 flushed before each launch, the host's
   enqueue hidden behind a device spin; the kernel's call is also timed
   with the host's time exposed) beside the bound.
4. ``kv_kernels`` — every kv_shuttle variant: the GEMM variants
   (``kernels.kv_shuttle.VARIANTS``) at ``KVTransfer``'s full width
   (T = d = 4096, dk = 512, f32) within 1e-4 of the plain version, and
   the ``pure`` cache handoffs (``PURE_VARIANTS``) at the llama3.2-1b
   engine's cache size in bf16, bit for bit; timed as in phase 3 beside
   two ``torch.matmul`` (GEMM) or one ``Tensor.copy_`` (pure).
5. ``main``    — the moe path with every launch counter at 0:
   ``fast_path`` on ``ServingStep(n_dev=4)`` and ``MoEDispatch(n_dev=4)``
   (the seed must be the kernel's ``PALLAS_RDMA`` directive at level 3),
   then the same evaluator scores the Table-3 directives and three more;
   every one must reach level 3. The counters are read right after.
6. ``kv_main`` — the KV-transfer search with the kv counters at 0:
   ``fast_path`` on ``KVTransfer()`` with full-width verification inputs
   (the seed must be ``PALLAS_RDMA`` at level 3 through the kernel), then
   eight more directives, each to level 3.
7. ``serve``   — the llama3.2-1b serving engine at full width with the
   kv counters at 0: 8 prompts of 512 tokens, ``generate`` 32 tokens
   (after a warm-up ``generate`` on an engine of its own),
   then ``prefill_remote`` through the shuttle (chained, and fused
   COUNTER at kv_chunk 1024) + ``decode_from_handoff``: each shuttled
   cache bit-equal to the direct handoff, the tokens equal to
   ``generate``'s, the first decode step's logits within 5e-2
   (max-abs-normalised, bf16) of ``forward`` over the 513 tokens; then
   ``serve`` answers 4 requests of mixed prompt lengths.

``--iters`` sets the timed launches per kernel (1 for a quick check after
a kernel change). The line before the last is the ``kernels`` JSON
record (launches from the counted paths: moe records from ``main``, the
kv GEMM records from ``kv_main``, the pure records from ``serve``); the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
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
KV_SOURCE = "src/repro_torch/csrc/kv_shuttle.cu"
KV_REPLACES = "src/repro/kernels/kv_shuttle.py:163"
LOGIT_TOL = 5e-2           # bf16 decode step vs forward, max-abs-normalised

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
    """Build and load both kernels (one ``nvcc`` per source, started
    together) and print ptxas's resource lines and the co-resident grid
    of each launch shape."""
    from repro_torch.kernels import build, kv_shuttle, moe_dispatch
    if torch.device(device).type != "cuda":
        log("build: skipped on the cpu (kernels need nvcc and a card)")
        return
    t0 = time.perf_counter()
    build.build(["moe_dispatch", "kv_shuttle"])
    libs = [moe_dispatch.load_kernel(), kv_shuttle.load_kernel()]
    log(f"build: moe_dispatch + kv_shuttle in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(lib._name for lib in libs)})")
    for name in ("moe_dispatch", "kv_shuttle"):
        for line in build.ptxas_log(name):
            log(f"ptxas {name}: {line.strip()}")
    for shared in (False, True):
        for i8 in (False, True):
            grid, per_sm = moe_dispatch.grid_for(device, 4, shared, i8)
            log(f"grid: moe_dispatch shared={shared} int8={i8}: {grid} CTAs "
                f"({per_sm} per SM)")
    grid, per_sm = kv_shuttle.grid_for(device)
    log(f"grid: kv_shuttle: {grid} CTAs ({per_sm} per SM), {grid - 1} "
        "prefill + 1 decode")


HIDE_CYCLES = 5_000_000    # ~2.5 ms of device spin ahead of each timed call


def time_ms(fn, device, iters, flush, hide_host=True):
    """Mean ms of ``fn()``: CUDA events around each call after a warm-up,
    with the L2 overwritten before each call; host clock on the cpu. With
    ``hide_host`` a device-side spin (``torch.cuda._sleep``) runs ahead of
    the start event while the host enqueues the call, so the events time
    the device's work from the call's first operation to its last; without
    it they also time the host's Python between the two events."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(HIDE_CYCLES)
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
            call = lambda: moe_dispatch_combine(x, w1, w2,  # noqa: E731
                                                shared=shared, **kw)
            k_ms = time_ms(call, device, iters, flush)
            call_ms = time_ms(call, device, iters, flush, hide_host=False)
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
                f"max abs err {abs_err:.3e}; kernel {k_ms:.3f} ms (call "
                f"{call_ms:.3f} ms with the host's time), "
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


# ------------------------------------------------------------ kv_shuttle


def kv_workload(small=False):
    """The KV-transfer workload at its defaults (``small``: test size)."""
    from repro_torch.workloads.kv_transfer import KVTransfer
    return KVTransfer(T=128, d=64, dk=32) if small else KVTransfer()


def kv_inputs(w, device, seed=0):
    """Full-width inputs of ``w`` from ``seed``: x (2, T, d) with the
    prefill rank's activations in row 0, wk/wv (d, dk) / sqrt(d). (The
    workload's ``example_inputs`` stay at the reference's verification
    size, T <= 128, d/8, dk/4.)"""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    x = torch.zeros((2, w.T, w.d), device=device)
    x[0] = torch.randn((w.T, w.d), **kw)
    wk = torch.randn((w.d, w.dk), **kw) / w.d ** 0.5
    wv = torch.randn((w.d, w.dk), **kw) / w.d ** 0.5
    return x, wk, wv


def engine_config(small=False):
    """The model the serve phase runs: llama3.2-1b at full width (16
    layers, d=2048, GQA 32/8, vocab 128256, bf16); ``small``: the
    reference's reduced test size."""
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch("llama3.2-1b")
    return reduced(cfg) if small else cfg


def serve_shape(small=False):
    """(batch, prompt tokens, new tokens) of the serve phase."""
    return (2, 16, 4) if small else (8, 512, 32)


def cache_rows(cfg, batch, max_seq):
    """Rows of one [K; V] half of the engine's cache handoff: every
    (repeat, batch, slot, kv head) is a row of hd values."""
    return cfg.num_repeats * batch * max_seq * cfg.num_kv_heads


def kv_bound(*, pure, rows, width, d=0, esize=4):
    """Least time of one shuttle call on an H100: operations over the f32
    rate or bytes over HBM, whichever is larger. Bytes: the prefill rank's
    operand read once (x[0] and both weights; or the stacked [K; V]
    cache), both (2, rows, width) outputs written once (the decode rank's
    rows and the prefill rank's zero rows). The decode rank's input row
    never enters the result, so it is not counted."""
    out = 2 * 2 * rows * width * esize
    if pure:
        flops, inp = 0, 2 * rows * width * esize
    else:
        flops = 2 * 2 * rows * d * width
        inp = (rows * d + 2 * d * width) * esize
    t_ops, t_bytes = flops / F32_FLOPS, (inp + out) / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, inp + out)


def phase_kv_kernels(device="cuda", workload=None, cfg=None, shape=None,
                     iters=5):
    """Hold every kv_shuttle variant against its plain version: the GEMM
    variants on ``workload``'s full-width inputs (1e-4 max-abs-normalised:
    the K sum runs in another order, no TF32 on either side), the pure
    ones on a bf16 cache of the serve phase's handoff size (bit for bit).
    Returns one record per variant for the ``kernels`` line."""
    from repro_torch.kernels.kv_shuttle import (PURE_VARIANTS, VARIANTS,
                                                kv_cache_shuttle, kv_shuttle,
                                                kv_shuttle_plain,
                                                variant_name)
    cuda = torch.device(device).type == "cuda"
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device) \
        if cuda else None
    w = workload or kv_workload()
    cfg = cfg or engine_config()
    batch, prompt, new = shape or serve_shape()
    x, wk, wv = kv_inputs(w, device)
    rows = cache_rows(cfg, batch, prompt + new + 1)
    g = torch.Generator(device=device).manual_seed(1)
    kv = torch.zeros((2, 2 * rows, cfg.hd), dtype=torch.bfloat16,
                     device=device)
    kv[0] = torch.randn((2 * rows, cfg.hd), generator=g, device=device)
    sink = torch.empty_like(kv[0])
    cases = [(False, knobs) for knobs in VARIANTS.values()] \
        + [(True, knobs) for knobs in PURE_VARIANTS.values()]
    lib_ms = {False: time_ms(lambda: (torch.matmul(x[0], wk),
                                      torch.matmul(x[0], wv)),
                             device, iters, flush),
              True: time_ms(lambda: sink.copy_(kv[0]), device, iters, flush)}
    out = []
    for pure, knobs in cases:
        if pure:
            run = lambda: kv_cache_shuttle(kv, **knobs)  # noqa: E731
            plain = lambda: kv_shuttle_plain(kv, pure=True, **knobs)  # noqa: E731
            n_rows, width, esize, d = rows, cfg.hd, 2, 0
        else:
            run = lambda: kv_shuttle(x, wk, wv, **knobs)  # noqa: E731
            plain = lambda: kv_shuttle_plain(x, wk, wv, **knobs)  # noqa: E731
            n_rows, width, esize, d = w.T, w.dk, 4, w.d
        key = variant_name(pure=pure, rows=n_rows, **knobs)
        with torch.no_grad():
            got, want = run(), plain()
        if cuda:
            torch.cuda.synchronize(device)
        abs_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
        rel = max(float((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-9))
                  for a, b in zip(got, want))
        if pure:
            ok, tol = all(torch.equal(a, b) for a, b in zip(got, want)), \
                "bit-exact"
        else:
            ok = rel <= 1e-4 and all(bool(torch.isfinite(a).all())
                                     for a in got)
            tol = "1e-04"
        del got, want
        k_ms = time_ms(run, device, iters, flush)
        call_ms = time_ms(run, device, iters, flush, hide_host=False)
        p_ms = time_ms(plain, device, iters, flush)
        b_ms, b_by, flops, nbytes = kv_bound(pure=pure, rows=n_rows,
                                             width=width, d=d, esize=esize)
        lib = "copy_" if pure else "matmul"
        log(f"kernel kv_shuttle/{key} rows={n_rows} width={width} d={d} "
            f"{'bf16' if pure else 'f32'}: rel err {rel:.3e} (tol {tol}), "
            f"max abs err {abs_err:.3e}; kernel {k_ms:.3f} ms (call "
            f"{call_ms:.3f} ms with the host's time), plain {p_ms:.3f} ms, "
            f"{lib} {lib_ms[pure]:.3f} ms, bound {b_ms:.3f} ms "
            f"by {b_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel kv_shuttle/{key} disagrees with its "
                             f"plain version: rel err {rel:.3e}")
        out.append({"name": f"kv_shuttle/{key}", "route": "cuda",
                    "source": KV_SOURCE, "replaces": KV_REPLACES,
                    "launches": None, "max_abs_err": abs_err, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms[pure],
                    "_key": (key, n_rows, width,
                             "bfloat16" if pure else "float32"),
                    "_path": "serve" if pure else "kv_main"})
    del x, wk, wv, kv, sink
    return out


def kv_directives():
    """Table 3's points, the chained and fused-SIGNAL shuttles, FLUX at
    32-row chunks, and DeepEP (IB) with the ``chained`` tunable flipped."""
    from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
    return dict(EXPERT_SYSTEMS, **{
        "chained": Directive("PALLAS_RDMA", "SIGNAL", "STREAM_SPLIT", "LOCAL",
                             "KERNEL", "PER_PEER", "ACQUIRE", 2),
        "fused SIGNAL": Directive("PALLAS_RDMA", "SIGNAL", "TILE_FUSED",
                                  "LOCAL", "GRID_STEP", "PER_TILE",
                                  "ACQUIRE", 2),
        "FLUX kc32": EXPERT_SYSTEMS["FLUX"].with_tunable("kv_chunk", 32),
        "DeepEP (IB) chained": EXPERT_SYSTEMS["DeepEP (IB)"].with_tunable(
            "chained", 1),
    })


def phase_kv_main(device="cuda", workload=None):
    """The KV-transfer search, counted: fast_path, then every directive
    of :func:`kv_directives` through the same evaluator, on full-width
    verification inputs. Returns the kv_shuttle launch counter."""
    from repro_torch.core.cascade import Candidate, CascadeEvaluator
    from repro_torch.core.design_space import directive_key
    from repro_torch.core.fast_path import fast_path
    from repro_torch.core.hardware import H100, extract_hardware_context
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import kv_shuttle as kern
    w = workload or kv_workload()
    mesh = VirtualMesh(2, device=device)
    hw = extract_hardware_context(mesh, H100)
    ev = CascadeEvaluator(w, mesh, hw, wallclock=True,
                          verify_inputs=kv_inputs(w, device, seed=2))
    log(f"context {w.name} T={w.T} d={w.d} dk={w.dk}: {hw.topology_summary}")
    kern.reset_launches()
    t0 = time.perf_counter()
    seed = fast_path(w, mesh, hw, evaluator=ev)
    res = seed.candidate.result
    log(f"fast_path {w.name}: {seed.directive.backend} level {res.level} "
        f"score {res.score:.2f} in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {kern.launches()}")
    for line in seed.log:
        log(f"  {line}")
    if seed.directive.backend != "PALLAS_RDMA" or res.level != 3:
        raise SystemExit(f"fast path on {w.name} fell back to "
                         f"{seed.directive.backend}")
    if torch.device(device).type == "cuda" and kern.launches() == 0:
        raise SystemExit(f"fast path on {w.name} launched no kernel")
    for name, d in kv_directives().items():
        r = ev.evaluate(Candidate(d, mutation=name))
        log(f"cascade {w.name} {name}: level {r.level} score {r.score:.3f} "
            f"t_model_ms {r.t_model_ms:.4f} (H100 model) t_wall_ms "
            f"{r.t_wall_ms:.4f} ({ev.device}) knobs {r.record.knobs} "
            f"key {directive_key(d)}")
        if r.level != 3:
            raise SystemExit(f"{name} on {w.name} stopped at level "
                             f"{r.level}: {r.diagnostic}")
    return dict(kern.LAUNCHES)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def phase_serve(device="cuda", cfg=None, shape=None):
    """The serving engine, counted: generate, the two shuttled handoffs
    (each cache bit-equal to the direct handoff, each token stream equal
    to generate's), the first decode step against ``forward``, then
    ``serve`` over 4 requests. Returns the kv_shuttle launch counter."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import kv_shuttle as kern
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models.model import lm_logits
    from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
    cfg = cfg or engine_config()
    batch, prompt, new = shape or serve_shape()
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    g = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                           device=device)
    sync()
    log(f"serve {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} vocab {cfg.vocab_size} "
        f"{cfg.dtype}; weights from seed 0 in {time.perf_counter() - t0:.1f} s")
    b = {"tokens": tokens}
    # warm-up on an engine of its own: first-use kernel loading and the
    # BLAS handles' set-up stay out of the timed engine's metrics
    Engine(cfg, params, ServeConfig(max_seq=prompt + new + 1)).generate(b, 2)
    eng = Engine(cfg, params, ServeConfig(max_seq=prompt + new + 1))
    kern.reset_launches()
    t0 = time.perf_counter()
    toks = eng.generate(b, new)
    sync()
    gen_s = time.perf_counter() - t0
    snap = eng.metrics.snapshot()["histograms"]
    pre_ms = snap["serve.prefill_ms"]["mean"]
    dec_ms = snap["serve.decode_step_ms"]["mean"]
    log(f"serve generate: {batch} x {prompt} prompt tokens -> {new} new in "
        f"{gen_s:.3f} s; prefill {pre_ms:.3f} ms "
        f"({batch * prompt / pre_ms * 1e3:.0f} prompt tok/s), decode "
        f"{dec_ms:.3f} ms/step ({batch / dec_ms * 1e3:.0f} tok/s)")
    direct = eng.prefill_remote(b)
    for name, kw in (("chained", {}),
                     ("fused COUNTER kc1024",
                      dict(fused=True, counter=True, kv_chunk=1024))):
        t0 = time.perf_counter()
        h = eng.prefill_remote(b, shuttle_mesh=VirtualMesh(2, device=device),
                               **kw)
        sync()
        hand_s = time.perf_counter() - t0
        same = all(torch.equal(h["cache"][blk][leaf], direct["cache"][blk][leaf])
                   for blk in direct["cache"] for leaf in direct["cache"][blk])
        out = eng.decode_from_handoff(h, new)
        sync()
        equal = torch.equal(out, toks)
        rows = h["cache"]["s0"]["k"].numel() // cfg.hd
        log(f"serve handoff {name}: prefill + shuttle {hand_s:.3f} s, "
            f"{rows} rows x {cfg.hd} per half; cache bit-equal to the direct "
            f"handoff: {same}; decode tokens equal generate's: {equal}")
        if not (same and equal):
            raise SystemExit(f"handoff {name} differs from the direct one")
    with torch.no_grad():
        dl, _ = decode_step(params, direct["cache"],
                            direct["first_token"][:, None], prompt, cfg)
        grown = torch.cat([tokens, direct["first_token"][:, None].long()], 1)
        x, _ = forward(params, {"tokens": grown}, cfg)
        fl = lm_logits(params, x[:, -1:], cfg)
    rel = _rel(dl, fl)
    finite = bool(torch.isfinite(dl).all())
    log(f"serve decode step vs forward over {prompt + 1} tokens: logits "
        f"{tuple(dl.shape)}, rel err {rel:.3e} (tol {LOGIT_TOL:.0e}), "
        f"finite {finite}")
    if not (finite and dl.shape == fl.shape and rel <= LOGIT_TOL):
        raise SystemExit("decode logits disagree with forward")
    lens = [prompt // 8, prompt // 4, prompt // 2 + 3, prompt]
    sched = Scheduler(token_budget=2 * prompt, max_batch=4,
                      metrics=eng.metrics)
    for rid, n in enumerate(lens):
        sched.submit(Request(rid, tokens[rid % batch, :n].tolist(),
                             max_new_tokens=new // 4 + rid))
    t0 = time.perf_counter()
    done = eng.serve(sched)
    sync()
    counters = eng.metrics.snapshot()["counters"]
    log(f"serve scheduler: {len(done)} of {len(lens)} requests done in "
        f"{time.perf_counter() - t0:.3f} s (prompt lengths {lens}); counters "
        f"{json.dumps(counters, sort_keys=True)}")
    if sorted(done) != list(range(len(lens))) or any(
            len(done[r]) != new // 4 + r for r in done) \
            or counters.get("sched.finished") != len(lens):
        raise SystemExit("serve left requests unfinished")
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
    records += phase_kv_kernels("cuda", iters=args.iters)
    counted = {"main": phase_main("cuda")}
    counted["kv_main"] = phase_kv_main("cuda")
    counted["serve"] = phase_serve("cuda")
    for path, counts in counted.items():
        log(f"launches on the {path} path: {counts}")
    for rec in records:
        rec["launches"] = counted[rec.pop("_path", "main")].get(
            rec.pop("_key"), 0)
        if rec["launches"] == 0:
            raise SystemExit(f"{rec['name']} was not launched on its "
                             "counted path")
    log(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
