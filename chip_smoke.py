#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one H100:

    python3 chip_smoke.py

Phases (each a function a test can call with ``device="cpu"`` at tiny
sizes; every run runs all of them, and any failure exits non-zero):

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — build the five Hopper kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, started together)
   and print ptxas's register / shared-memory / spill lines and each
   launch's grid (moe: each rank's routed and second-stream CTAs; the
   ring: each rank's CTAs from ``ring_ctas`` at the defaults and at
   fig3's largest row; kv_shuttle: each core's; gemm_allgather: its
   registers, spills, dynamic shared memory and CTAs per SM).
3. ``gemm_core`` — the moe kernel's tile core (``csrc/wg_tile.cuh``'s
   ``wgmma`` core) alone at the main path's GEMM shapes (serving's expert
   GEMM1 with SwiGLU and its GEMM2, the same for the skewed cell's busiest
   expert, kv_transfer's projection, the KV cell's, the LongCat cell's,
   prefill_skew's busiest expert at skew 5, a packed 64-row unit), within
   1e-4 of its plain version, timed
   beside ``torch.matmul`` and the 3xTF32 bound; at the KV cell's shape
   (8192 rows, d 4096 into 2 x 1024 columns) kv_shuttle.cu's ``wgmma``
   core alone (``csrc/wg_tile.cuh``) beside them.
4. ``ga_core`` — gemm_allgather taken apart at ``GemmAllGather``'s
   defaults: its split phase alone (``gemm_allgather_split``, bit for bit
   against the plain split), the kernel at n = 1 with M_l = 4096 (the
   same 137.4 GFLOP with no peer) and its split there, one
   ``torch.matmul``, the 3xTF32 bound: split, GEMM and broadcast. Then
   the ``-D`` builds of ``GA_KNOBS`` (the partial sums' depth, the tile
   group) beside the production build: the error at K = 4096 and 7168
   and the times that set those two constants.
5. ``kernels`` — every moe_dispatch variant the main path runs
   (``kernels.moe_dispatch.VARIANTS``), on the inputs of the main path's
   two workloads (serving width and the skewed MoEDispatch shape): the
   kernel against its plain version on the same inputs (max-abs-normalised
   error within 1e-4 for the f32 wire, 1e-3 for the int8 wire), with the
   kernel's, the plain version's and the same GEMMs' ``torch.matmul`` time
   (CUDA events, warmed, L2 flushed before each launch, the host's
   enqueue hidden behind a device spin; the kernel's call is also timed
   with the host's time exposed) beside the bound. Every kernel phase
   checks, times and logs through ``Bench.record``.
6. ``kv_kernels`` — every kv_shuttle variant: the GEMM variants
   (``kernels.kv_shuttle.VARIANTS``) at ``KVTransfer``'s full width
   (T = d = 4096, dk = 512, f32) within 1e-4 of the plain version, and
   the ``pure`` cache handoffs (``PURE_VARIANTS``) at the llama3.2-1b
   engine's cache size in bf16, bit for bit; timed as in phase 5 beside
   two ``torch.matmul`` (GEMM) or one ``Tensor.copy_`` (pure).
7. ``main``    — the moe path with every launch counter at 0:
   ``fast_path`` on ``ServingStep(n_dev=4)`` and ``MoEDispatch(n_dev=4)``
   (the seed must be the kernel's ``PALLAS_RDMA`` directive at level 3),
   then the same evaluator scores the Table-3 directives and three more;
   every one must reach level 3. The counters are read right after.
8. ``kv_main`` — the KV-transfer search with the kv counters at 0:
   ``fast_path`` on ``KVTransfer()`` with full-width verification inputs
   (the seed must be ``PALLAS_RDMA`` at level 3 through the kernel), then
   eight more directives, each to level 3.
9. ``serve``   — the llama3.2-1b serving engine at full width with the
   kv counters at 0: 8 prompts of 512 tokens, ``generate`` 32 tokens
   (after a warm-up ``generate`` on an engine of its own),
   then ``prefill_remote`` through the shuttle (chained, and fused
   COUNTER at kv_chunk 1024) + ``decode_from_handoff``: each shuttled
   cache bit-equal to the direct handoff, the tokens equal to
   ``generate``'s, the first decode step's logits within 5e-2
   (max-abs-normalised, bf16) of ``forward`` over the 513 tokens; then
   ``serve`` answers 4 requests of mixed prompt lengths.
10. ``ga_kernels`` — every gemm_allgather variant
   (``kernels.gemm_allgather.VARIANTS``) at ``GemmAllGather``'s defaults
   (n=4, M=K=N=4096, f32) within 1e-4 of the plain version, timed as in
   phase 5 beside one ``torch.matmul`` of the gathered A plus the copy
   into the n outputs.
11. ``attn_kernels`` — every flash_attention variant over the ring's
   whole sequence (BH 8, S 4096, hd 64; f32 within 1e-4; bf16 each
   element within one bf16 step of the plain version plus 1e-4, both
   sides rounding an f32 result) and every ring_attention variant at
   ``RingAttention``'s defaults (f32 within 1e-4; the bf16 ring under
   the bf16 gate); timed beside ``scaled_dot_product_attention`` in the
   variant's type and against the bound (f32 at the 3xTF32 rate).
12. ``ga_main`` — the GEMM+AllGather search, counted like ``kv_main``:
    ``fast_path`` on ``GemmAllGather()`` with full-width verification
    inputs, then nine more directives, each to level 3.
13. ``ring_main`` — the ring-attention search, counted the same way
    (fast_path, then eleven directives), then ``kernels/ops.py``'s
    wrappers at work: the FLUX ring against flash attention over the
    gathered sequence and the oracle, bf16 flash and the bf16 FLUX ring
    against the oracle on their bf16 inputs, non-causal flash against the
    oracle, and at fig3's largest row (BH 96, seq 8192) the pipelined and
    FLUX rings and flash.
    The counters are read there; each deployment ring's output is then
    held against its plain version, flash (1e-4) and, on two heads, the
    oracle, and timed: the records of fig3's row.
14. ``ring_split`` — the ring's CTA split on the card: the pipelined and
    FLUX rings at the defaults and at fig3's row and the bf16 FLUX ring,
    each launched and timed on ``ring_ctas``' split, the split by
    attended tile pairs, the even split and a closed form that balances
    each rank's tile pairs alone; every launch's credit counters must
    show its split and its output pass the variant's gate.
15. ``moe_model_kernels`` (run with the kernel phases, before ``main``)
    — moe_dispatch at the llama4 MoE engine's prefill and decode shapes
    with the knobs ``models/moe.py::_pallas_body`` launches, held and
    timed as in phase 5; the ``decode tiles:`` line times the decode
    call's 64-row tiles with each weight read once (``gemm_core``).
16. ``slow_main`` — the slow path on the card with the moe counter at 0:
    ``fast_path`` then ``slow_path`` on ``ServingStep(n_dev=4)``, 3
    islands x 4 generations; every candidate past l0 and l1 at level 3,
    the kernel launched, the best at least the seed; then a 2-generation
    warm start from the saved store must serve cache hits.
17. ``serve_moe`` — llama4-maverick at its published widths (4 layers,
    4 experts, one per rank of a 4-rank data mesh), counted: 8 prompts
    of 512 tokens, ``generate`` 32 tokens through ``moe_dispatch.cu``
    (launches = MoE layers x 32), the host body's logits on the same
    token stream and its free-running tokens equal up to a first split
    that is a one-bf16-step tie, decode against ``forward``, ``serve`` of
    4 requests.
18. ``faults`` — the reference's fault suite on the card, counted: each
    of the five workloads at its full default width drops rank 1
    (``degrade``, unpadded) and the cascade on FLUX over a
    ``VirtualMesh`` of the survivors must reach level 3 through the
    kernels (moe_dispatch, gemm_allgather and the ring launched at n = 3);
    ``fault_cost`` above ``analytic_cost`` (H100 model); every modeled
    timeline valid and equal to its cost within 1e-6 s; the straggler
    stall falling with ``contexts``; a ``fault_report`` under two plans;
    wire faults classified at l2; a wedged build quarantined. Each of the
    three kernels is then held to its plain version on the degraded inputs
    and timed (records with a ``faults`` launch count), and the ring's
    test build times a slowed rank 2 at contexts 1, 2 and 4 beside the
    modeled stall.
19. ``serve_degrade`` — ``serve_moe``'s engine loses rank 3 at step 1 of
    ``serve`` (an ``ElasticController`` and a ``StragglerWatchdog``
    attached): the pallas degrade onto 2 ranks must raise, the hook
    switches to ``moe_backend="xla"`` and degrades, every request
    completes; at capacity 4 the degraded stream equals an undegraded
    engine's up to a first split that is a one-bf16-step tie.
20. ``window`` (run after ``moe_model_kernels``) — the send window of
    ``csrc/window.cuh`` on the card: every cooperative variant (moe on
    the serving and skewed cells, FLUX's also on the dropped rank's n = 3
    cells and the llama4 engine's shapes, kv_shuttle at KVTransfer's width and
    the engine's handoff, gemm_allgather at its defaults and the dropped
    rank's n = 3 slab, the ring at its defaults, bf16, fig3's row and
    n = 3) at contexts 1, 2 and 4, held to its plain version and timed,
    one ``window:`` line each; the probe builds' logs (``-DCUCO_PROBE``)
    held to the window contract by each kernel's ``check_log``; and
    gemm_allgather at one CTA a rank against ``ScheduleProbe.check``.
    Every counted path also prints the ``contexts`` its kernels launched
    at (``CONTEXTS_LAUNCHED``) and fails where a directive's did not
    reach the kernel.
21. ``serve_kernels`` (run with the kernel phases) — the two kernel
    shapes of phases 22 and 23: moe_dispatch on the padded layout of a
    decode group of 3 rows on 4 ranks, and kv_shuttle's pure handoff of
    whisper's cross cache (32 x 4 x 1500 x 20 rows of 64, bf16), held and
    timed as in phase 5.
22. ``serve_kinds`` — xlstm-350m (4 x 512 prompt tokens, 32 new),
    recurrentgemma-9b (2 x 2304, 16 new: past the 2048-token window) and
    whisper-large-v3 (4 x 64 decoder tokens over 1500 frames, 32 new)
    through the engine at full width and depth, bf16, counted: prefill
    ms, decode ms a step and tokens/s; the engine replays its own tokens;
    the first decode step within 5e-2 of ``forward``; whisper's shuttled
    handoff (``[k; v]`` and ``[ck; cv]``) bit-equal to the direct one and
    its tokens equal ``generate``'s; the recurrent kinds' shuttled handoff
    refused.
23. ``serve_mixed`` — ``serve_moe``'s engine under pallas serves 6
    requests of 4 prompt lengths and 5 ``max_new_tokens``, two of them
    submitted at step 2: every group is one that does not shard, and runs
    the kernel's padded layout (launches = MoE layers x groups); at
    capacity 4 the tokens equal an xla engine's ``serve`` up to a
    one-bf16-step tie, at 1.25 the agreement is printed.

24. ``serve_tp`` — granite-moe-3b-a800m at full width and depth, bf16,
    8 x 512 prompts, 32 new, on a ``("data", "model")`` mesh of (1, 4)
    (the replicated expert body: experts over the model axis, partials
    summed) against no mesh (bf16 and float32), its handoff through
    ``kv_shuttle.cu`` (counted), and on a data-only (4,) mesh; llama4's
    engine on a (4, 2) mesh (ff-sharded all-to-all and gathered bodies)
    against (4,), and ``moe_backend="pallas"`` raising there. Each
    number beside the card's name and power limit. Its kernel shape,
    kv_shuttle's pure handoff of granite's cache, is held and timed with
    the kernel phases (``phase_tp_kernels``).
25. ``train`` — the trainer (``train/loop.py::train``: AdamW in place,
    remat, checkpoints) with every kernel's launch counter at 0 before
    and after (it launches no hand-written kernel: the reference trains
    through XLA, and no Pallas kernel has a backward): llama3.2-1b at
    every published width and depth, 8 x 512, 6 steps, and one step with
    remat off from the same state; granite-moe at its published widths,
    8 of its 32 layers, on the (1, 4) data x model mesh, 8 x 512, 4
    steps, step 0's loss against no mesh; the 100M MoE config of
    ``examples/train_moe_100m.py`` on (4, 2) with ``moe_overlap``, 16 x
    256, 8 steps resumed through a checkpoint bit for bit under
    deterministic algorithms, restored with no mesh and trained on;
    ``moe_backend="pallas"`` raising under autograd. Each step's loss,
    gradient norm and ms, tokens/s, the share of 989 TFLOP/s that 6 N
    tokens reaches and the peak memory, beside the card's name and power
    limit.
26. ``dryrun`` — the dry run (``launch/dryrun.py``, a ``TorchDispatchMode``
    count of the torch step, ``core/op_count.py``) on three production
    cells on meta (llama3.2-1b, granite-moe and xlstm-350m at
    ``train_4k`` on 16 x 16; xLSTM's scaled in its loops' trip counts),
    then held against the card: ``train_dense``'s step, the llama
    engine's prefill at 8 x 512 and one decode step, ``train_moe``'s
    step and ``train_xlstm``'s (two units, 4 x 512), each timed and
    counted on the card and on meta (FLOPs, bytes and collectives
    equal; xLSTM's also equal to its scaled count), the H100 model's
    ``compute_s``, ``memory_s`` and ``step_time_s`` beside the measured
    step (the bound may not exceed it), the arguments and op_count's
    peak against ``max_memory_allocated``.
27. ``examples`` — ``repro_torch.examples``' four scripts at their
    smallest arguments on the card (``codesign_search`` counted: its
    cascade launches ``moe_dispatch.cu``) and ``schedule_lint`` clean.
28. ``suites`` — the reference's five acceptance suites
    (``repro_torch.suites``, ``tests/scripts/*_suite.py``), counted as one
    path: the workload suite (moe_dispatch, kv_shuttle, gemm_allgather and
    ring_attention against each workload's oracle); telemetry,
    search_scale and serving on the reference's ``V5E`` context, whose
    artifacts must equal the checked-in ``BENCH_search.json``,
    ``BENCH_search_scale.json`` and ``BENCH_serving.json``; then those
    three and verify on the ``H100`` model into ``build/suites/``: search
    wall s a candidate, the warm-start and transfer payoffs, the four
    serving rows, l0 and l2 ms and their ratio against the reference's
    0.1 gate. Four ``kernels``-line records at the workload suite's
    shapes.
29. ``figures`` — the paper's tables and figures (``repro_torch.figures``,
    ``benchmarks/``), counted as one path: fig3, fig4 at n 2 and 8, fig5,
    fig6 and table5 on the ``H100`` model, each point its workload's
    ``check`` accepts run at the paper's shape (fig3's ring at BH 96, seq
    8192; fig4's 4096 tokens a rank at d 7168; fig5's T 8192, dk 1024;
    fig6's 8192^3; table5's 6144 tokens on the int8 wire) through its
    Hopper kernel (host points plain torch), held to the workload's
    oracle (2e-3; 0.1 on the int8 wire) and timed: one ``figure`` line a
    point (H100 model beside the card), one ``figure order`` line a shape
    (the card's order of its points against the model's); fig9-13
    through the card's cascade at ``GENS`` 10 on 4 ranks; ``roofline_cells``
    over the cells phase ``dryrun`` wrote to ``artifacts/dryrun_torch/``.
    Tables in ``build/figures/``; six ``kernels``-line records at the
    figures' largest shapes.

``--iters`` sets the timed launches per kernel (1 for a quick check after
a kernel change). The line before the last is the ``kernels`` JSON
record (each row's ``contexts`` the send window it was timed at; launches
from the counted paths: moe records from ``main``, the
kv GEMM records from ``kv_main``, the pure records from ``serve``,
gemm_allgather from ``ga_main``, flash and ring from ``ring_main``, the
moe records at the llama4 shapes from ``serve_moe``, the n = 3 records
from ``faults``, the padded decode record from ``serve_mixed``, whisper's
cross handoff from ``serve_kinds``, granite's handoff from
``serve_tp``, the workload suite's records from ``suites``, the
figures' records from ``figures``); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with a fixed workspace, read when the
# process first uses it: phase ``train`` compares runs under
# ``torch.use_deterministic_algorithms``
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from repro_torch.core.hardware import card_label  # noqa: E402

# f32-accurate products on the TF32 tensor cores: 3xTF32 issues three TF32
# products per multiply-add, at the data sheet's 495 TFLOP/s dense TF32
TF32X3_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (data sheet)
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3 (data sheet)
SOURCE = "src/repro_torch/csrc/moe_dispatch.cu"
REPLACES = "src/repro/kernels/moe_dispatch.py:415"
KV_SOURCE = "src/repro_torch/csrc/kv_shuttle.cu"
KV_REPLACES = "src/repro/kernels/kv_shuttle.py:163"
GA_SOURCE = "src/repro_torch/csrc/gemm_allgather.cu"
GA_REPLACES = "src/repro/kernels/gemm_allgather.py:193"
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:72"
RING_SOURCE = "src/repro_torch/csrc/ring_attention.cu"
RING_REPLACES = "src/repro/kernels/ring_attention.py:197"
LOGIT_TOL = 5e-2           # bf16 decode step vs forward, max-abs-normalised
F32_LOGIT_TOL = 1e-3       # the same in float32 (sums in another order)

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


KERNELS = ("moe_dispatch", "kv_shuttle", "gemm_allgather", "flash_attention",
           "ring_attention")


def phase_build(device="cuda"):
    """Build and load every kernel (one ``nvcc`` per source, started
    together) and print ptxas's resource lines and the co-resident grid
    of each launch shape."""
    from repro_torch.kernels import (build, flash_attention, gemm_allgather,
                                     kv_shuttle, moe_dispatch, ring_attention)
    if torch.device(device).type != "cuda":
        log("build: skipped on the cpu (kernels need nvcc and a card)")
        return
    t0 = time.perf_counter()
    # with the counting builds, which load_kernel would otherwise compile
    # one after the other
    build.build_jobs([(name, ()) for name in KERNELS],
                     [(name, build.STATS_DEFINES)
                      for name in ("moe_dispatch", "kv_shuttle")])
    libs = [m.load_kernel() for m in (moe_dispatch, kv_shuttle,
                                      gemm_allgather, flash_attention,
                                      ring_attention)]
    log(f"build: {' + '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(lib._name for lib in libs)})")
    for name in KERNELS:
        for line in build.ptxas_log(name):
            log(f"ptxas {name}: {line.strip()}")
    for w in main_path_workloads():
        T = min(w.T, 256)             # the tokens example_inputs makes
        counts = [int(c) for c in w._counts(T)]
        shared = (T, w.f_shared) if w.second_stream else None
        for i8 in (False, True):
            grid, per_sm = moe_dispatch.grid_for(device, w.n_dev,
                                                 shared is not None, i8)
            ctas = moe_dispatch.rank_ctas(
                grid, moe_dispatch.make_schedule(counts), w.f, shared)
            log(f"grid: moe_dispatch {w.name} counts={counts} int8={i8}: "
                f"{grid} CTAs ({per_sm} per SM); per rank (routed, second "
                f"stream) {ctas}")
    for core in kv_shuttle.CORE_IDS:
        grid, per_sm = kv_shuttle.grid_for(device, core)
        log(f"grid: kv_shuttle {core} core: {grid} CTAs ({per_sm} per SM), "
            f"{grid - 1} prefill + 1 decode")
    grid, per_sm = gemm_allgather.grid_for(device, 4)
    regs, stores, loads = ptxas_resources(build.ptxas_log("gemm_allgather"),
                                          "gemm_allgather_kernel")
    log(f"grid: gemm_allgather n=4: {grid} CTAs ({per_sm} per SM), "
        f"{grid // 4} per rank; {regs} registers, spill stores {stores} / "
        f"loads {loads} bytes, {gemm_allgather.smem_bytes()} bytes of "
        f"dynamic shared memory a CTA")
    w, (dBH, dseq) = ring_workload(), deploy_shape()
    n, dsl = w.n_dev, dseq // w.n_dev
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            grid, per_sm = ring_attention.grid_for(device, n, hd, dtype=dtype)
            log(f"grid: ring_attention n={n} hd<={hd} {str(dtype)[6:]}: "
                f"{grid} CTAs ({per_sm} per SM); per rank at the defaults "
                f"(BH {w.BH}, Sl {w.sl}) "
                f"{ring_attention.ring_ctas(grid, n, w.BH, w.sl)}, at the "
                f"deployment row (BH {dBH}, Sl {dsl}) "
                f"{ring_attention.ring_ctas(grid, n, dBH, dsl)}")


def ptxas_resources(lines, entry):
    """``(registers, spill store bytes, spill load bytes)`` of the kernel
    whose mangled name holds ``entry``, from ptxas ``-v`` lines (None for
    what the lines do not give: a library loaded from the cache)."""
    regs = stores = loads = None
    compiling = props = ""
    for line in lines:
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            compiling = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            if entry in props:
                stores, loads = int(m.group(1)), int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            if entry in compiling:
                regs = int(m.group(1))
    return regs, stores, loads


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


BF16_ULP = 2.0 ** -7       # one bf16 step is at most 2^-7 of the value
BF16_FLOOR = 1e-4          # beside it: the f32 noise of values near 0


def _close(name, got, want, tol):
    """Hold ``got`` to ``want`` (tensors, or tuples of them) and exit when
    they disagree. ``tol`` is a float, the max-abs-normalised error
    allowed (and ``got`` must be finite); ``"bf16"``, each element within
    one bf16 step of ``want`` plus 1e-4 (where both sides round an f32
    result to bf16, a right kernel is at most one rounding step off); or
    ``"exact"``, bit for bit. Returns (reading, max abs err): the
    max-abs-normalised error, or for ``"bf16"`` the largest
    ``|got - want| / (2^-7 |want| + 1e-4)``, which must stay <= 1."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    reading = abs_err = 0.0
    ok = len(got) == len(want)
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise SystemExit(f"{name}: shape {tuple(g.shape)}, want "
                             f"{tuple(w.shape)}")
        diff = (g.float() - w.float()).abs()
        abs_err = max(abs_err, float(diff.max()))
        if tol == "exact":
            ok = ok and torch.equal(g, w)
            reading = max(reading, float(diff.max() / (w.float().abs().max()
                                                       + 1e-9)))
            continue
        if tol == "bf16":
            r = float((diff / (BF16_ULP * w.float().abs() + BF16_FLOOR)).max())
        else:
            r = float(diff.max() / (w.float().abs().max() + 1e-9))
        reading = max(reading, r)
        ok = ok and bool(torch.isfinite(g).all()) and r <= (
            1.0 if tol == "bf16" else tol)
    if not ok:
        raise SystemExit(f"{name} disagrees: {_reading(reading, tol)}")
    return reading, abs_err


def _reading(reading, tol):
    if tol == "exact":
        return f"rel err {reading:.3e} (bit-exact)"
    if tol == "bf16":
        return (f"bf16 step ratio {reading:.3e} (tol 1: |got - want| <= "
                f"2^-7 |want| + {BF16_FLOOR:.0e})")
    return f"rel err {reading:.3e} (tol {tol:.0e})"


class Bench:
    """Checks and times kernels on one device: ``iters`` timed calls of
    each (:func:`time_ms`, the L2 flushed before each), one record of the
    ``kernels`` line per kernel and shape."""

    def __init__(self, device, iters):
        self.device, self.iters = device, iters
        self.cuda = torch.device(device).type == "cuda"
        self.flush = torch.empty(64 * 2**20, dtype=torch.int32,
                                 device=device) if self.cuda else None

    def ms(self, fn, hide_host=True):
        return time_ms(fn, self.device, self.iters, self.flush, hide_host)

    def record(self, name, shape_txt, run, plain, tol, bnd, lib, source,
               replaces, key, path, got=None, contexts=2):
        """Hold ``run()`` (or ``got``, the output of a counted run) against
        ``plain()`` within ``tol`` (:func:`_close`), time the kernel (with
        and without the host's time), the plain version, and log them
        beside ``lib`` (its name and ms) and ``bnd`` (ms, bound by, flops,
        bytes or None). ``key`` and ``path`` name the launch count the
        record takes from the counted run of ``path``; ``contexts`` is the
        send window ``run`` launches at (the wrappers' default 2; None for
        a kernel without one)."""
        with torch.no_grad():
            got = run() if got is None else got
            want = plain()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        reading, abs_err = _close(f"kernel {name}", got, want, tol)
        del got, want
        k_ms = self.ms(run)
        call_ms = self.ms(run, hide_host=False)
        p_ms = self.ms(plain)
        b_ms, b_by, flops, nbytes = bnd
        lib_name, lib_ms = lib
        work = f"{flops / 1e9:.1f} GFLOP" + (
            "" if nbytes is None else f", {nbytes / 1e6:.1f} MB")
        log(f"kernel {name} {shape_txt} contexts={contexts}: "
            f"{_reading(reading, tol)}, max abs "
            f"err {abs_err:.3e}; kernel {k_ms:.3f} ms (call {call_ms:.3f} ms "
            f"with the host's time), plain {p_ms:.3f} ms, {lib_name} "
            f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by} ({work}) -> ok")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": None, "max_abs_err": abs_err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms, "contexts": contexts,
                "_key": key, "_path": path}


def gemm_core_shapes(small=False):
    """(name, M, K, N, swiglu) of the ``gemm_core`` line: the serving
    cell's expert GEMM1 (256 routed rows, d=7168, 2f=4096, with SwiGLU;
    decode_shared's rows into an expert) and GEMM2 (f=2048 -> d), the
    skewed cell's busiest expert (12 microblocks of 64 rows, d=512,
    f=1024), kv_transfer's projection (T = d = 4096, dk = 512), the KV
    cell's (``KV_CORE``: 8192 rows, d 4096 into 2 x 1024 columns, on both
    cores), the LongCat cell's products on the core (1024 tokens a step:
    the router, d 6144 into 512 + 256 experts, and FFN2's two GEMMs, d
    into 2 x 12288 with SwiGLU and 12288 back to d), prefill_skew's
    busiest expert at skew 5 (4 sources x 52 microblocks of 64 rows, d
    7168, f 2048) and one packed 64-row unit of the LongCat cell's routed
    stream (d 6144, f 2048); ``small``: test size."""
    if small:
        return [("moe_gemm1_swiglu", 70, 64, 256, True),
                ("moe_gemm2", 70, 128, 64, False),
                ("skewed_gemm1_swiglu", 64, 32, 128, True),
                ("skewed_gemm2", 64, 64, 32, False),
                ("kv_projection", 130, 96, 40, False),
                (KV_CORE, 130, 96, 80, False),
                ("scmoe_router", 128, 64, 24, False),
                ("scmoe_ffn2_gemm1_swiglu", 128, 64, 256, True),
                ("scmoe_ffn2_gemm2", 128, 128, 64, False),
                ("prefill_skew5_gemm1_swiglu", 200, 64, 256, True),
                ("prefill_skew5_gemm2", 200, 128, 64, False),
                ("scmoe_packed_gemm1_swiglu", 64, 64, 256, True),
                ("scmoe_packed_gemm2", 64, 128, 64, False)]
    return [("moe_gemm1_swiglu", 256, 7168, 2 * 2048, True),
            ("moe_gemm2", 256, 2048, 7168, False),
            ("skewed_gemm1_swiglu", 768, 512, 2 * 1024, True),
            ("skewed_gemm2", 768, 1024, 512, False),
            ("kv_projection", 4096, 4096, 512, False),
            (KV_CORE, 8192, 4096, 2 * 1024, False),
            ("scmoe_router", 1024, 6144, 512 + 256, False),
            ("scmoe_ffn2_gemm1_swiglu", 1024, 6144, 2 * 12288, True),
            ("scmoe_ffn2_gemm2", 1024, 12288, 6144, False),
            ("prefill_skew5_gemm1_swiglu", 4 * 52 * 64, 7168, 2 * 2048, True),
            ("prefill_skew5_gemm2", 4 * 52 * 64, 2048, 7168, False),
            ("scmoe_packed_gemm1_swiglu", 64, 6144, 2 * 2048, True),
            ("scmoe_packed_gemm2", 64, 2048, 6144, False)]


# the gemm_core line's row that also runs kv_shuttle.cu's wgmma core alone
# (csrc/wg_tile.cuh, kernels.kv_shuttle.gemm_core) over the N columns as
# its two halves, K and V
KV_CORE = "kv_wgmma_core"


def phase_gemm_core(device="cuda", shapes=None, iters=5):
    """The moe kernel's tile core alone (``csrc/wg_tile.cuh``'s ``wgmma``
    core, one CTA an SM over the tiles, no flags) at the main path's GEMM
    shapes: held to its plain version
    within 1e-4 and timed beside one ``torch.matmul`` of the same product
    and the 3xTF32 bound, so a moe or kv variant's time splits into GEMM
    and the rest (dispatch, combine, waiting). The ``KV_CORE`` row also
    holds and times kv_shuttle.cu's ``wgmma`` core alone on the same
    product (``wgmma_ms``). Returns one dict a shape."""
    from repro_torch.kernels import kv_shuttle
    from repro_torch.kernels.moe_dispatch import gemm_core, gemm_core_plain
    bench = Bench(device, iters)
    out = []
    for name, M, K, N, swiglu in shapes or gemm_core_shapes():
        g = torch.Generator(device=device).manual_seed(M + K + N)
        a = torch.randn((M, K), generator=g, device=device)
        b = torch.randn((K, N), generator=g, device=device) / K ** 0.5
        with torch.no_grad():
            reading, abs_err = _close(f"gemm_core {name}",
                                      gemm_core(a, b, swiglu=swiglu),
                                      gemm_core_plain(a, b, swiglu=swiglu),
                                      1e-4)
        core_ms = bench.ms(lambda: gemm_core(a, b, swiglu=swiglu))
        mm_ms = bench.ms(lambda: torch.matmul(a, b))
        flops = 2 * M * K * N
        bound_ms = flops / TF32X3_FLOPS * 1e3
        rec = {"name": name, "ms": core_ms, "matmul_ms": mm_ms,
               "bound_ms": bound_ms}
        wg_txt = ""
        if name == KV_CORE:
            wk, wv = b[:, :N // 2].contiguous(), b[:, N // 2:].contiguous()
            wg_reading, _ = _close(f"gemm_core {name} (wgmma)",
                                   kv_shuttle.gemm_core(a, wk, wv),
                                   (a @ wk, a @ wv), 1e-4)
            rec["wgmma_ms"] = bench.ms(lambda: kv_shuttle.gemm_core(a, wk,
                                                                    wv))
            wg_txt = (f"; wgmma core {_reading(wg_reading, 1e-4)}, "
                      f"{rec['wgmma_ms']:.3f} ms "
                      f"({flops / rec['wgmma_ms'] / 1e9:.1f} TFLOP/s)")
            del wk, wv
        log(f"gemm_core {name} M={M} K={K} N={N}"
            f"{' +swiglu' if swiglu else ''}: {_reading(reading, 1e-4)}, "
            f"max abs err {abs_err:.3e}; core {core_ms:.3f} ms "
            f"({flops / core_ms / 1e9:.1f} TFLOP/s){wg_txt}, matmul "
            f"{mm_ms:.3f} ms ({flops / mm_ms / 1e9:.1f} TFLOP/s), 3xTF32 "
            f"bound {bound_ms:.3f} ms")
        out.append(rec)
        del a, b
    return out


def moe_bound(n, counts, d, f, fs=0, Ts=0, xs_is_x=True):
    """Least time of one moe_dispatch call on an H100: its f32-accurate
    operations over the 3xTF32 rate, or bytes (each input read once, each
    output written once) over HBM — whichever is larger. Each of the n
    ranks routes ``counts[e]`` rows to expert e (T rows in all); the second
    stream runs the shared expert (width ``fs``) over ``Ts`` rows a rank,
    which are x itself (``xs_is_x``, read once) or an input of their own.
    The kernel runs its f32 GEMMs on the tensor cores as 3xTF32
    (``csrc/wg_tile.cuh``), so three TF32 products per multiply-add are
    the least the card can do for this accuracy; against the f32 SIMT rate
    a right kernel could read over 100% of its bound. Returns (ms, bound
    by, flops, bytes)."""
    T = sum(counts)
    flops = sum(6 * n * c * d * f for c in counts) + 6 * n * Ts * d * fs
    elems = n * T * d + n * d * 2 * f + n * f * d + n * T * d
    if fs:
        elems += d * 2 * fs + fs * d + n * Ts * d * (1 if xs_is_x else 2)
    t_ops, t_bytes = flops / TF32X3_FLOPS, 4 * elems / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, 4 * elems)


def bound(w, counts):
    """:func:`moe_bound` of one call of workload ``w``'s kernel (its shared
    expert runs over x itself): (ms, bound by, flops)."""
    fs = w.f_shared if w.second_stream else 0
    return moe_bound(w.n_dev, counts, w.d, w.f, fs, sum(counts))[:3]


def moe_library(bench, x, w1, w2, counts, shared):
    """``("matmul", ms)``: the kernel's routed and shared GEMMs as one
    ``torch.matmul`` each, on the same inputs."""
    n, f = x.shape[0], w2.shape[1]
    offs = [sum(counts[:e]) for e in range(n)]

    def library():
        for e in range(n):
            h = torch.matmul(x[:, offs[e]:offs[e] + counts[e]], w1[e])
            torch.matmul(h[..., :f], w2[e])
        if shared is not None:
            xs, s1, s2 = shared
            h = torch.matmul(xs, s1)
            torch.matmul(h[..., :s2.shape[0]], s2)

    return "matmul", bench.ms(library)


def moe_record(bench, label, x, w1, w2, counts, shared, knobs, block_tokens,
               bnd, lib, path):
    """Hold one moe_dispatch variant (``knobs``) against its plain version
    on these inputs and time it (:meth:`Bench.record`); the launch count
    comes from the counted run of ``path``."""
    from repro_torch.kernels.moe_dispatch import (moe_dispatch_combine,
                                                  moe_dispatch_combine_ref,
                                                  variant_name)
    n, T, d = x.shape
    f = w2.shape[1]
    fs = shared[2].shape[0] if shared is not None else 0
    wire_i8 = knobs.get("wire_i8", False)
    kw = dict(counts=counts, block_tokens=block_tokens, tight=True, **knobs)
    key = variant_name(
        barrier=knobs.get("barrier", False),
        pipelined=knobs.get("pipelined", True),
        tile_fused=knobs.get("tile_fused", False), wire_i8=wire_i8,
        shared=shared is not None, combine_tile=knobs.get("combine_tile"),
        block_tokens=block_tokens)
    return bench.record(
        f"moe_dispatch/{key}@{label}",
        f"n={n} T={T} d={d} f={f} fs={fs} B={block_tokens} counts={counts}",
        lambda: moe_dispatch_combine(x, w1, w2, shared=shared, **kw),
        lambda: moe_dispatch_combine_ref(
            x, w1, w2, counts=counts, block_tokens=block_tokens, tight=True,
            wire_i8=wire_i8, shared=shared),
        1e-3 if wire_i8 else 1e-4, bnd, lib, SOURCE, REPLACES,
        (key, n, T, d, f), path)


def phase_kernels(device="cuda", workloads=None, iters=5):
    """Hold every variant against its plain version on each workload's
    inputs. Returns one record per (variant, workload) for the ``kernels``
    line; ``main`` fills in ``launches``."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels.moe_dispatch import VARIANTS
    bench = Bench(device, iters)
    out = []
    for w in workloads or main_path_workloads():
        ins = w.example_inputs(0, VirtualMesh(w.n_dev, device=device))
        x, w1, w2 = ins[:3]
        shared = (x, *ins[3:]) if w.second_stream else None
        counts = [int(c) for c in w._counts(x.shape[1])]
        lib = moe_library(bench, x, w1, w2, counts, shared)
        for knobs in VARIANTS.values():
            out.append(moe_record(bench, w.name, x, w1, w2, counts, shared,
                                  knobs, 64, (*bound(w, counts), None), lib,
                                  "main"))
        del x, w1, w2, shared, ins
    return out

# ----------------------------------------------------------------- ScMoE


def scmoe_workload(small=False):
    """LongCat-Flash's ScMoE double-layer (``workloads/scmoe.py``) at the
    benchmark cell's shapes: 8 ranks of 128 tokens, d 6144, expert f 2048,
    dense FFNs 12288, 512 FFN + 256 zero experts, top-12; ``small``: the
    CPU tests' size."""
    from repro_torch.workloads.scmoe import ScMoEStep
    if small:
        return ScMoEStep(n_dev=8, tokens_per_rank=16, d=64, f=64,
                         f_dense=128, n_experts=16, n_zero=8, topk=6)
    return ScMoEStep()


def scmoe_directive():
    """The cell's point: tile-fused COUNTER, contexts 2, tight."""
    from repro_torch.core.design_space import Directive
    return Directive("PALLAS_RDMA", "COUNTER", "TILE_FUSED", "LOCAL",
                     "GRID_STEP", "PER_TILE", "ACQREL", 2).with_tunable(
                         "tight", 1)


def scmoe_bound(pairs, T, d, f, fs):
    """:func:`moe_bound` of a launch on a table of rows per (source,
    expert) pair: every routed row in and out once, the held experts, and
    the second stream (width ``fs``) over T rows a rank of an input of
    its own. Returns (ms, bound by, flops, bytes)."""
    n = len(pairs)
    per_expert = [sum(r[e] for r in pairs) / n for e in range(n)]
    return moe_bound(n, per_expert, d, f, fs, T, xs_is_x=False)


def phase_scmoe(device="cuda", workload=None, iters=5):
    """The ScMoE path, counted: one double-layer through the cell's build
    (the router and FFN2 on ``gemm_core``, one ``moe_kernel`` launch on a
    table of rows per (source, destination) pair with FFN1 as the second
    stream), launch counts reset just before it, held to
    ``models/longcat_ref.py`` with the layer's own picks. Then the kernel
    alone on that layer's rows, table and FFN1 operands, held to
    ``moe_dispatch_combine_ref`` and timed (:func:`moe_record`). Returns
    (launch counter, [record])."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import moe_dispatch as kern
    from repro_torch.models import longcat_ref
    from repro_torch.workloads.scmoe import record_routes, rms_norm
    w = workload or scmoe_workload()
    mesh = VirtualMesh(w.n_dev, device=device)
    ins = w.example_inputs(0, mesh, T=w.T)
    h, wr, b, w1, w2, s1, s2, t1, t2, g0, g1 = ins
    run = w.build(scmoe_directive(), mesh)
    kern.reset_launches()
    with torch.no_grad(), record_routes() as routes:
        got = run(*ins)
    counted = dict(kern.LAUNCHES)
    with torch.no_grad():
        want, _, gap = longcat_ref.double_layer(
            h, dict(zip(longcat_ref.LAYER_KEYS, ins[1:])), routes[0],
            n_experts=w.n_experts, topk=w.topk, scale=w.scale, eps=w.eps)
    reading, _ = _close("scmoe step", got, want, 1e-4)
    if gap > 1e-6:
        raise SystemExit(f"scmoe step: a pick lies {gap:.3e} below the "
                         "reference's top k")
    launched = sum(counted.values())
    if torch.device(device).type == "cuda" and launched != 1:
        raise SystemExit(f"scmoe step launched {launched} moe kernels, "
                         "want 1")
    log(f"scmoe step n={w.n_dev} T={w.T} d={w.d} f={w.f} fd={w.f_dense} "
        f"E={w.n_experts}+{w.n_zero} k={w.topk}: {_reading(reading, 1e-4)}, "
        f"route gap {gap:.3e}; launches {counted}")
    del got, want
    with torch.no_grad():
        u = rms_norm(h, g0, w.eps)
        picks, _ = w._route(u, wr, b, kern.gemm_core)
        rows, pairs, _, _ = w._layout(u, picks)
        pairs = pairs.tolist()
    knobs = {k: v for k, v in w.kernel_knobs(scmoe_directive()).items()
             if k in ("barrier", "pipelined", "tile_fused", "combine_tile")}
    shared = (u, s1, s2)
    bench = Bench(device, iters)

    def library():
        for e in range(w.n_dev):
            xe = torch.cat([rows[s, sum(pairs[s][:e]):sum(pairs[s][:e + 1])]
                            for s in range(w.n_dev)])
            torch.matmul(torch.matmul(xe, w1[e])[:, :w.f], w2[e])
        torch.matmul(torch.matmul(u, s1)[..., :w.f_dense], s2)

    rec = moe_record(bench, "scmoe_step", rows, w1, w2, pairs, shared, knobs,
                     64, scmoe_bound(pairs, w.T, w.d, w.f, w.f_dense),
                     ("matmul", bench.ms(library)), "scmoe")
    return counted, [rec]


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
    from repro_torch.kernels import moe_dispatch as kern
    kern.reset_launches()
    for w in workloads or main_path_workloads():
        _search(device, w, None, main_path_directives(), kern,
                f"n={w.n_dev} d={w.d} f={w.f}")
    _contexts_seen("main", [kern], _asked(main_path_directives()))
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
    """Least time of one shuttle call on an H100: operations over the
    3xTF32 rate (the projections run on the tensor cores as 3xTF32, as in
    :func:`bound`) or bytes over HBM, whichever is larger. Bytes: the
    prefill rank's operand read once (x[0] and both weights; or the
    stacked [K; V] cache), both (2, rows, width) outputs written once (the
    decode rank's rows and the prefill rank's zero rows). The decode
    rank's input row never enters the result, so it is not counted."""
    out = 2 * 2 * rows * width * esize
    if pure:
        flops, inp = 0, 2 * rows * width * esize
    else:
        flops = 2 * 2 * rows * d * width
        inp = (rows * d + 2 * d * width) * esize
    t_ops, t_bytes = flops / TF32X3_FLOPS, (inp + out) / HBM_BYTES_S
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
    bench = Bench(device, iters)
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
    lib = {False: ("matmul", bench.ms(lambda: (torch.matmul(x[0], wk),
                                               torch.matmul(x[0], wv)))),
           True: ("copy_", bench.ms(lambda: sink.copy_(kv[0])))}
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
        out.append(bench.record(
            f"kv_shuttle/{key}",
            f"rows={n_rows} width={width} d={d} {'bf16' if pure else 'f32'}",
            run, plain, "exact" if pure else 1e-4,
            kv_bound(pure=pure, rows=n_rows, width=width, d=d, esize=esize),
            lib[pure], KV_SOURCE, KV_REPLACES,
            (key, n_rows, width, "bfloat16" if pure else "float32"),
            "serve" if pure else "kv_main"))
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
    from repro_torch.kernels import kv_shuttle as kern
    w = workload or kv_workload()
    kern.reset_launches()
    _search(device, w, kv_inputs(w, device, seed=2), kv_directives(), kern,
            f"T={w.T} d={w.d} dk={w.dk}")
    _contexts_seen("kv_main", [kern], _asked(kv_directives()))
    return dict(kern.LAUNCHES)


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
    for name, kw in (("chained contexts=1", dict(contexts=1)),
                     ("fused COUNTER kc1024 contexts=4",
                      dict(fused=True, counter=True, kv_chunk=1024,
                           contexts=4))):
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
    rel, _ = _close("decode logits vs forward", dl, fl, LOGIT_TOL)
    log(f"serve decode step vs forward over {prompt + 1} tokens: logits "
        f"{tuple(dl.shape)}, {_reading(rel, LOGIT_TOL)}")
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
    _contexts_seen("serve", [kern], {1, 4})
    return dict(kern.LAUNCHES)


# --------------------------------------------------------- gemm_allgather


def ga_workload(small=False):
    """GemmAllGather at its defaults (n=4, M=K=N=4096, M_l=1024, f32;
    ``small``: test size)."""
    from repro_torch.workloads.gemm_allgather import GemmAllGather
    return GemmAllGather(M=256, K=64, N=48) if small else GemmAllGather()


def ga_inputs(w, device, seed=0):
    """Full-width inputs of ``w`` from ``seed``: a (n, M_l, K), b (K, N) /
    sqrt(K). (``example_inputs`` stays at the reference's verification
    size, M_l 128, K and N at most 128.)"""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    a = torch.randn((w.n_dev, w.M // w.n_dev, w.K), **kw)
    b = torch.randn((w.K, w.N), **kw) / w.K ** 0.5
    return a, b


def ga_bound(n, M_l, K, N):
    """Least time of one gemm_allgather call on an H100: the GEMM's
    f32-accurate operations over the 3xTF32 rate, or the bytes (a and b
    read once, the n gathered outputs written once) over HBM, whichever is
    larger. The kernel runs its GEMM on the tensor cores as 3xTF32
    (``csrc/wgmma_gemm.cuh``), three TF32 products per multiply-add, the
    least the card can do for this accuracy; against the f32 SIMT rate a
    right kernel could read over 100% of its bound."""
    flops = 2 * n * M_l * K * N
    nbytes = 4 * (n * M_l * K + K * N + n * n * M_l * N)
    t_ops, t_bytes = flops / TF32X3_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_ga_kernels(device="cuda", workload=None, iters=5):
    """Hold every gemm_allgather variant against its plain version on
    ``workload``'s full-width inputs (1e-4 max-abs-normalised: the
    kernel's 3xTF32 products carry f32 accuracy and sum K in another
    order than cuBLAS, which runs without TF32). Returns
    one record per variant for the ``kernels`` line."""
    from repro_torch.kernels.gemm_allgather import (VARIANTS, gemm_allgather,
                                                    gemm_allgather_plain,
                                                    variant_name)
    bench = Bench(device, iters)
    w = workload or ga_workload()
    a, b = ga_inputs(w, device)
    n, M_l, K = a.shape
    N = b.shape[1]
    sink = torch.empty((n, n * M_l, N), device=device)

    def library():
        # the gathered product as one torch.matmul, copied into n outputs
        sink.copy_(torch.matmul(a.reshape(-1, K), b)[None].expand_as(sink))

    lib = ("matmul+copy", bench.ms(library))
    out = []
    for knobs in VARIANTS.values():
        key = variant_name(M_l=M_l, **knobs)
        out.append(bench.record(
            f"gemm_allgather/{key}", f"n={n} M_l={M_l} K={K} N={N} f32",
            lambda: gemm_allgather(a, b, **knobs),
            lambda: gemm_allgather_plain(a, b, **knobs), 1e-4,
            ga_bound(n, M_l, K, N), lib, GA_SOURCE, GA_REPLACES,
            ("gemm_allgather", key, n, M_l, K, N), "ga_main"))
    del a, b, sink
    return out


# -D builds of gemm_allgather.cu read beside the production build by
# ga_core: the stages summed in one partial (production 4) and the row
# tiles of a tile group (production 4; 1 is row by row)
GA_KNOBS = (("GA_PART_STAGES=1",), ("GA_PART_STAGES=8",), ("GA_GROUP_M=1",),
            ("GA_GROUP_M=8",))


def ga_deep_inputs(w, device, K=7168):
    """One rank of ``w``'s rows at depth ``K`` (the partial sums' deepest
    reading): a (1, M_l, K), b (K, N) / sqrt(K)."""
    g = torch.Generator(device=device).manual_seed(K)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    return (torch.randn((1, w.M // w.n_dev, K), **kw),
            torch.randn((K, w.N), **kw) / K ** 0.5)


def phase_ga_core(device="cuda", workload=None, iters=5):
    """gemm_allgather's time taken apart at ``workload``'s full width: the
    split phase alone (``gemm_allgather_split``) at n ranks, bit for bit
    against its plain version; the kernel at n = 1 with M_l = M (the same
    GEMM, no peer, held to its plain version within 1e-4) and its split at
    n = 1; one ``torch.matmul`` of the same product; the 3xTF32 bound. The
    GEMM phase is the n = 1 kernel less its split; a variant's time less
    the split at n ranks and the GEMM is its broadcast and waits. Then, on
    the card, each build of :data:`GA_KNOBS` beside the production build:
    the error at K = 4096 (n = 1) and K = 7168, the n = 1 kernel's time
    and ``fused_counter``'s at n ranks."""
    from repro_torch.kernels.gemm_allgather import (gemm_allgather,
                                                    gemm_allgather_plain,
                                                    launch_built_with,
                                                    split_operands,
                                                    split_operands_plain)
    bench = Bench(device, iters)
    w = workload or ga_workload()
    a, b = ga_inputs(w, device)
    n, M_l, K = a.shape
    N = b.shape[1]
    a1 = a.reshape(1, n * M_l, K)
    with torch.no_grad():
        _close("ga_core split", split_operands(a, b),
               split_operands_plain(a, b), "exact")
        reading, abs_err = _close("ga_core n=1", gemm_allgather(a1, b),
                                  gemm_allgather_plain(a1, b), 1e-4)
    split_ms = bench.ms(lambda: split_operands(a, b))
    split1_ms = bench.ms(lambda: split_operands(a1, b))
    one_ms = bench.ms(lambda: gemm_allgather(a1, b))
    mm_ms = bench.ms(lambda: torch.matmul(a1[0], b))
    flops = 2 * n * M_l * K * N
    bound_ms = flops / TF32X3_FLOPS * 1e3
    gemm_ms = one_ms - split1_ms
    log(f"ga_core n={n} M_l={M_l} K={K} N={N}: split {split_ms:.3f} ms "
        f"(n={n}), kernel at n=1 M_l={n * M_l} {one_ms:.3f} ms "
        f"({_reading(reading, 1e-4)}, max abs err {abs_err:.3e}) of which "
        f"split {split1_ms:.3f} ms and GEMM {gemm_ms:.3f} ms "
        f"({flops / gemm_ms / 1e9:.1f} TFLOP/s), matmul {mm_ms:.3f} ms "
        f"({flops / mm_ms / 1e9:.1f} TFLOP/s), 3xTF32 bound {bound_ms:.3f} "
        f"ms")
    rec = {"split_ms": split_ms, "split1_ms": split1_ms, "one_ms": one_ms,
           "gemm_ms": gemm_ms, "matmul_ms": mm_ms, "bound_ms": bound_ms,
           "knobs": {}}
    if not bench.cuda:
        log("ga_core: the -D builds are skipped on the cpu")
        return rec
    a7, b7 = ga_deep_inputs(w, device)
    for defines in ((),) + GA_KNOBS:
        with torch.no_grad():
            r4, _ = _close(f"ga_core {defines} K={K}",
                           launch_built_with(defines, a1, b),
                           gemm_allgather_plain(a1, b), 1e-4)
            r7, _ = _close(f"ga_core {defines} K=7168",
                           launch_built_with(defines, a7, b7),
                           gemm_allgather_plain(a7, b7), 1e-4)
        k_one = bench.ms(lambda: launch_built_with(defines, a1, b))
        k_fc = bench.ms(lambda: launch_built_with(defines, a, b,
                                                  counter=True))
        name = " ".join(defines) or "production"
        log(f"ga_knob {name}: rel err K={K} {r4:.3e}, K=7168 {r7:.3e}; "
            f"kernel at n=1 {k_one:.3f} ms, fused_counter at n={n} "
            f"{k_fc:.3f} ms")
        rec["knobs"][name] = {"err_k": r4, "err_k7168": r7,
                              "one_ms": k_one, "fused_counter_ms": k_fc}
    del a, b, a1, a7, b7
    return rec


def ga_directives():
    """Table 3's points, fig6's deferred point, the STREAM_SPLIT build at 4
    chunks, FLUX at 32-row tiles, fused SIGNAL, and BARRIER under
    TILE_FUSED (the deferred drain)."""
    from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
    return dict(EXPERT_SYSTEMS, **{
        "fig6 deferred": Directive("PALLAS_RDMA", "SIGNAL", "DEFERRED",
                                   "LOCAL", "KERNEL", "PER_PEER", "RELEASE",
                                   2),
        "stream_split": Directive("XLA_COLLECTIVE", placement="STREAM_SPLIT",
                                  contexts=2, tunables=(("chunks", 4),)),
        "FLUX tm32": EXPERT_SYSTEMS["FLUX"].with_tunable("tile_m", 32),
        "fused SIGNAL": Directive("PALLAS_RDMA", "SIGNAL", "TILE_FUSED",
                                  "LOCAL", "GRID_STEP", "PER_TILE",
                                  "ACQUIRE", 2),
        "fused BARRIER": Directive("PALLAS_RDMA", "BARRIER", "TILE_FUSED",
                                   "LOCAL", "GRID_STEP", "PER_TILE",
                                   "RELEASE", 2),
    })


def _search(device, w, inputs, directives, kern, label):
    """fast_path on ``w`` with ``inputs`` as the verification inputs (the
    workload's ``example_inputs`` when None), then every directive through
    the same evaluator; each must reach level 3 and the seed must be
    ``PALLAS_RDMA`` through ``kern``'s kernel. Returns the evaluator."""
    from repro_torch.core.cascade import Candidate, CascadeEvaluator
    from repro_torch.core.design_space import directive_key
    from repro_torch.core.fast_path import fast_path
    from repro_torch.core.hardware import H100, extract_hardware_context
    from repro_torch.dist.mesh import VirtualMesh
    mesh = VirtualMesh(w.n_dev, device=device)
    hw = extract_hardware_context(mesh, H100)
    ev = CascadeEvaluator(w, mesh, hw, wallclock=True, verify_inputs=inputs)
    log(f"context {w.name} {label}: {hw.topology_summary}; device "
        f"{hw.device_name or mesh.device} ({hw.sm_count} SMs)")
    t0 = time.perf_counter()
    before = kern.launches()
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
    for name, d in directives.items():
        r = ev.evaluate(Candidate(d, mutation=name))
        log(f"cascade {w.name} {name}: level {r.level} score {r.score:.3f} "
            f"t_model_ms {r.t_model_ms:.4f} (H100 model) t_wall_ms "
            f"{r.t_wall_ms:.4f} ({ev.device}) knobs {r.record.knobs} "
            f"key {directive_key(d)}")
        if r.level != 3:
            raise SystemExit(f"{name} on {w.name} stopped at level "
                             f"{r.level}: {r.diagnostic}")
    return ev


def _prefixed(name, launches):
    return {(name, *key): count for key, count in launches.items()}


KERNEL_BACKENDS = ("PALLAS_RDMA", "HYBRID")


def _asked(directives):
    """The ``contexts`` of the directives that build a kernel."""
    return {d.contexts for d in directives.values()
            if d.backend in KERNEL_BACKENDS}


def _contexts_seen(path, kerns, want=None):
    """The send windows ``kerns`` launched at on ``path`` (their
    ``CONTEXTS_LAUNCHED``, reset with the launch counters): printed, and
    on a card each of ``want`` must be among them."""
    seen = sorted({c for k in kerns for c in k.CONTEXTS_LAUNCHED})
    log(f"contexts on the {path} path: launched at {seen}"
        + ("" if want is None else f", the directives ask {sorted(want)}"))
    cuda = any(k.launches() for k in kerns)
    if cuda and not set(want or ()) <= set(seen):
        raise SystemExit(f"{path}: the directives' contexts {sorted(want)} "
                         f"did not all reach the kernel ({seen})")
    return seen


def phase_ga_main(device="cuda", workload=None):
    """The GEMM+AllGather search, counted: fast_path, then every directive
    of :func:`ga_directives`, on full-width verification inputs. Returns
    the gemm_allgather launch counter."""
    from repro_torch.kernels import gemm_allgather as kern
    w = workload or ga_workload()
    kern.reset_launches()
    _search(device, w, ga_inputs(w, device, seed=2), ga_directives(), kern,
            f"M={w.M} K={w.K} N={w.N}")
    _contexts_seen("ga_main", [kern], _asked(ga_directives()))
    return _prefixed("gemm_allgather", kern.LAUNCHES)


# ----------------------------------------------------- flash / ring attention


def ring_workload(small=False):
    """RingAttention at its defaults (n=4, BH=8, seq=4096, hd=64, causal,
    f32, sl=1024; ``small``: test size)."""
    from repro_torch.workloads.ring_attention import RingAttention
    return RingAttention(BH=2, seq=512, hd=16) if small else RingAttention()


def deploy_shape(small=False):
    """(BH, seq) of fig3's largest row, the paper's deployment: 12 x 8
    heads over 8192 tokens (``small``: test size)."""
    return (3, 768) if small else (96, 8192)


def ring_inputs(w, device, seed=0, BH=None, seq=None):
    """q, k, v (n, BH, seq / n, hd) from ``seed``, f32, at ``w``'s width
    (or the given BH and seq)."""
    BH, seq = BH or w.BH, seq or w.seq
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (w.n_dev, BH, seq // w.n_dev, w.hd)
    return tuple(torch.randn(shape, generator=g, device=device,
                             dtype=torch.float32) for _ in range(3))


def gathered(t):
    """(n, BH, Sl, hd) ranks -> (BH, n*Sl, hd), the whole sequence."""
    n, BH, Sl, hd = t.shape
    return t.permute(1, 0, 2, 3).reshape(BH, n * Sl, hd)


def attn_bound(BH, S, hd, causal=True, esize=4):
    """Least time of attention over (BH, S, hd) on an H100: the score and
    value products over the pairs this mask keeps (S(S+1)/2 causal, S^2
    otherwise) over the rate of the input type (f32: f32-accurate on the
    tensor cores, 3xTF32's 165 TFLOP/s, as the kernels compute it; bf16:
    989 TFLOP/s), or q, k, v read and the output written once over HBM,
    whichever is larger."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * BH * hd * pairs
    nbytes = 4 * BH * S * hd * esize
    rate = TF32X3_FLOPS if esize == 4 else BF16_FLOPS
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _sdpa(q, k, v, causal):
    """One ``scaled_dot_product_attention`` over (BH, S, hd), on a card on
    the memory-efficient backend (it takes f32; the math backend would
    build the whole score matrix). A yardstick only: the port never calls
    it."""
    import contextlib

    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]) if q.is_cuda \
            else contextlib.nullcontext():
        return torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal)[0]


def phase_attn_kernels(device="cuda", workload=None, iters=5):
    """Hold every flash_attention variant (over the ring's whole sequence,
    BH 8 x S 4096 x hd 64: f32 within 1e-4; bf16 each element within one
    bf16 step plus 1e-4, as both sides round an f32 result) and every
    ring_attention variant (at RingAttention's defaults, within 1e-4: sums
    in another order; ``BF16_VARIANTS`` on the same inputs in bf16, under
    the bf16 gate) against its plain version, timed beside the bound,
    the plain version and ``scaled_dot_product_attention``. Returns one
    record per variant for the ``kernels`` line. (fig3's largest row is
    checked and timed by ``ring_main``, on the outputs of its counted
    run.)"""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ring_attention as ra
    bench = Bench(device, iters)
    w = workload or ring_workload()
    out = []
    q, k, v = ring_inputs(w, device)
    flat = [gathered(t).contiguous() for t in (q, k, v)]
    BH, S, hd = flat[0].shape
    for key, knobs in fa.VARIANTS.items():
        causal, dtype = knobs["causal"], knobs["dtype"]
        fq, fk, fv = (t.to(dtype) for t in flat)
        bf16 = dtype == torch.bfloat16
        out.append(bench.record(
            f"flash_attention/{key}",
            f"BH={BH} S={S} hd={hd} {'bf16' if bf16 else 'f32'}",
            lambda: fa.flash_attention(fq, fk, fv, causal=causal),
            lambda: fa.flash_attention_plain(fq, fk, fv, causal=causal),
            "bf16" if bf16 else 1e-4,
            attn_bound(BH, S, hd, causal, esize=2 if bf16 else 4),
            ("sdpa", bench.ms(lambda: _sdpa(fq, fk, fv, causal))),
            FA_SOURCE, FA_REPLACES, ("flash_attention", key, BH, S, S, hd),
            "ring_main", contexts=None))
        del fq, fk, fv
    n, BH, Sl, hd = q.shape
    for dtype, variants in ((torch.float32, ra.VARIANTS),
                            (torch.bfloat16, ra.BF16_VARIANTS)):
        rq, rk, rv = (t.to(dtype) for t in (q, k, v))
        bf16 = dtype == torch.bfloat16
        whole = [gathered(t).contiguous() for t in (rq, rk, rv)]
        lib = ("sdpa", bench.ms(lambda: _sdpa(*whole, True)))
        del whole
        for key, knobs in variants.items():
            out.append(bench.record(
                f"ring_attention/{key}",
                f"n={n} BH={BH} Sl={Sl} hd={hd} {'bf16' if bf16 else 'f32'}",
                lambda: ra.ring_attention(rq, rk, rv, **knobs),
                lambda: ra.ring_attention_plain(rq, rk, rv, **knobs),
                "bf16" if bf16 else 1e-4,
                attn_bound(BH, w.seq, hd, True, esize=2 if bf16 else 4), lib,
                RING_SOURCE, RING_REPLACES,
                ("ring_attention", key, n, BH, Sl, hd), "ring_main"))
        del rq, rk, rv
    del q, k, v, flat
    return out

def balanced_split(grid, n, BH, Sl, causal=True):
    """The closed form the search is held against: each CTA added in turn
    to the rank whose busiest CTA attends the most tile pairs over the n
    steps (ceil(BH nqt / c_r) pieces of ``ring_work`` / (BH nqt) pairs
    each; ties to the later rank), with no wait between ranks counted."""
    from repro_torch.kernels.ring_attention import TILE, ring_work
    pieces = BH * -(-Sl // TILE)
    per_piece = [w / pieces for w in ring_work(n, BH, Sl, causal)]
    ctas = [1] * n
    for _ in range(grid - n):
        cost = [-(-pieces // c) * w for c, w in zip(ctas, per_piece)]
        ctas[max(range(n), key=lambda r: (cost[r], r))] += 1
    return ctas


def split_candidates(grid, n, BH, Sl, causal=True):
    """The CTA splits phase ``ring_split`` runs the ring on: ``ring_ctas``
    (the search against ``ring_makespan``), the split by attended tile
    pairs (``cta_split`` over ``ring_work``), the even split and
    :func:`balanced_split`."""
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels.split import cta_split
    return {"ring_ctas": ra.ring_ctas(grid, n, BH, Sl, causal),
            "pairs": cta_split(grid, ra.ring_work(n, BH, Sl, causal)),
            "even": cta_split(grid, [1] * n),
            "balanced": balanced_split(grid, n, BH, Sl, causal)}


def phase_ring_split(device="cuda", workload=None, deploy=None, iters=5):
    """The ring's CTA split on the card: the pipelined and FLUX rings at
    the defaults and at fig3's largest row (f32) and the bf16 FLUX ring
    at the defaults, each launched on every split of
    :func:`split_candidates`. Each launch's credit counters must show the
    split it was given and its output must pass the variant's gate
    against the plain version; the ``split:`` lines give each split's
    device time. Returns {(variant, BH, split name): ms}. Skipped on the
    cpu, where no split is launched."""
    from unittest import mock

    from repro_torch.kernels import ring_attention as ra
    if torch.device(device).type != "cuda":
        log("ring_split: skipped on the cpu (a split is a launch's)")
        return {}
    bench = Bench(device, iters)
    w = workload or ring_workload()
    cases = [(BH, seq, dtype, key) for BH, seq, dtype, keys in (
        (w.BH, w.seq, torch.float32, DEPLOY_VARIANTS),
        (w.BH, w.seq, torch.bfloat16, tuple(ra.BF16_VARIANTS)),
        (*(deploy or deploy_shape()), torch.float32, DEPLOY_VARIANTS))
        for key in keys]
    out = {}
    for BH, seq, dtype, key in cases:
        knobs = dict(ra.VARIANTS, **ra.BF16_VARIANTS)[key]
        q, k, v = (t.to(dtype) for t in ring_inputs(w, device, seed=4, BH=BH,
                                                     seq=seq))
        n, _, Sl, hd = q.shape
        bf16 = dtype == torch.bfloat16
        grid, _ = ra.grid_for(q.device, n, hd, dtype=dtype)
        launch = dict(dict(causal=True, kv_chunk=None, fused=False,
                           counter=False, pipelined=True, eager_wait=False,
                           contexts=2), **knobs)
        with torch.no_grad():
            want = ra.ring_attention_plain(q, k, v, **knobs)
        line = []
        for name, ctas in split_candidates(grid, n, BH, Sl).items():
            with mock.patch.object(ra, "ring_ctas",
                                   lambda *a, c=ctas, **kw: list(c)):
                with torch.no_grad():
                    got, done = ra._launch(q, k, v, stall=None, **launch)
                if done.cpu().tolist() != [c * max(n - 2, 0) for c in ctas]:
                    raise SystemExit(f"ring_split {key} {name}: the credit "
                                     f"counters read {done.tolist()}, not "
                                     f"the split {ctas}")
                _close(f"ring_split {key} {name}", got, want,
                       "bf16" if bf16 else 1e-4)
                del got, done
                ms = bench.ms(lambda: ra.ring_attention(q, k, v, **knobs))
            out[(key, BH, name)] = ms
            line.append(f"{name} {ctas} {ms:.3f} ms")
        log(f"split: ring_attention/{key} n={n} BH={BH} Sl={Sl} hd={hd} "
            f"{'bf16' if bf16 else 'f32'} ({grid} CTAs): " + "; ".join(line))
        del q, k, v, want
    return out


def ring_directives():
    """Table 3's points, fig3's host, deferred and flux points, the
    lazy-fence pipelined point (PER_TILE: the ring's check rejects fig3's
    PER_PEER cuco point) and its ACQREL (eager) twin, fused SIGNAL, and
    FLUX at 16-row chunks."""
    from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
    pipelined = Directive("PALLAS_RDMA", "SIGNAL", "TILE_PIPELINED", "LOCAL",
                          "KERNEL", "PER_TILE", "RELEASE", 2)
    return dict(EXPERT_SYSTEMS, **{
        "fig3 host": Directive("XLA_COLLECTIVE", placement="DEFERRED"),
        "fig3 deferred": Directive("PALLAS_RDMA", "SIGNAL", "DEFERRED",
                                   "LOCAL", "KERNEL", "PER_PEER", "RELEASE",
                                   2),
        "fig3 flux": EXPERT_SYSTEMS["FLUX"].with_tunable("kv_chunk", 64),
        "pipelined": pipelined,
        "pipelined ACQREL": dataclasses.replace(pipelined, ordering="ACQREL"),
        "fused SIGNAL": Directive("PALLAS_RDMA", "SIGNAL", "TILE_FUSED",
                                  "LOCAL", "GRID_STEP", "PER_TILE",
                                  "ACQUIRE", 2),
        "FLUX kc16": EXPERT_SYSTEMS["FLUX"].with_tunable("kv_chunk", 16),
    })


DEPLOY_VARIANTS = ("pipelined", "fused_counter")


def phase_ring_main(device="cuda", workload=None, deploy=None, iters=5):
    """Ring attention, counted: the search (fast_path, then every
    directive of :func:`ring_directives`, on full-width verification
    inputs), then the public wrappers at work — ``ops.ring_attention``
    (FLUX) against ``ops.flash_attention`` over the gathered sequence and
    the evaluator's oracle (f32 within 1e-4), bf16 flash and the bf16
    FLUX ring against the oracle on the same bf16 inputs (each element
    within one bf16 step plus 1e-4), non-causal flash against
    ``flash_attention_ref`` — and at
    fig3's largest row the pipelined and FLUX rings and flash over the
    whole sequence. The counters are read there; then each deployment
    ring's output is held against its plain version, against flash and,
    on two heads, the oracle (1e-4), and the ring is timed (the records
    of fig3's row). Returns the ring_attention and flash_attention launch
    counters and those records."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels.ref import flash_attention_ref
    w = workload or ring_workload()
    ra.reset_launches()
    fa.reset_launches()
    q, k, v = ring_inputs(w, device, seed=2)
    ev = _search(device, w, (q, k, v), ring_directives(), ra,
                 f"BH={w.BH} seq={w.seq} hd={w.hd}")
    mesh = VirtualMesh(w.n_dev, device=device)
    flux = ra.VARIANTS["fused_counter"]
    with torch.no_grad():
        ring = gathered(ops.ring_attention(q, k, v, mesh, **flux))
        fq, fk, fv = (gathered(t).contiguous() for t in (q, k, v))
        bq, bk, bv = (t.bfloat16() for t in (fq, fk, fv))
        want = gathered(ev.expected)
        flash = ops.flash_attention(fq, fk, fv, causal=True)
        bref = flash_attention_ref(bq, bk, bv)
        bring = gathered(ops.ring_attention(
            *(t.bfloat16() for t in (q, k, v)), mesh,
            **ra.BF16_VARIANTS["fused_counter_bf16"]))
        checks = [("ring vs flash", ring, flash, 1e-4),
                  ("flash vs oracle", flash, want, 1e-4),
                  ("bf16 flash vs oracle on its bf16 inputs",
                   ops.flash_attention(bq, bk, bv), bref, "bf16"),
                  ("bf16 ring vs oracle on its bf16 inputs", bring, bref,
                   "bf16"),
                  ("non-causal flash vs oracle",
                   ops.flash_attention(fq, fk, fv, causal=False),
                   flash_attention_ref(fq, fk, fv, causal=False), 1e-4)]
        for name, got, ref, tol in checks:
            reading, _ = _close(name, got, ref, tol)
            log(f"attention {name} BH={w.BH} S={w.seq} hd={w.hd}: "
                f"{_reading(reading, tol)}")
        del ring, flash, want, checks, q, k, v, fq, fk, fv, bq, bk, bv, bref, \
            bring
        BH, seq = deploy or deploy_shape()
        q, k, v = ring_inputs(w, device, seed=3, BH=BH, seq=seq)
        t0 = time.perf_counter()
        outs = {key: ops.ring_attention(q, k, v, mesh, **ra.VARIANTS[key])
                for key in DEPLOY_VARIANTS}
        fq, fk, fv = (gathered(t).contiguous() for t in (q, k, v))
        flash = ops.flash_attention(fq, fk, fv, causal=True)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        run_s = time.perf_counter() - t0
        counts = {**_prefixed("ring_attention", ra.LAUNCHES),
                  **_prefixed("flash_attention", fa.LAUNCHES)}
        _contexts_seen("ring_main", [ra], _asked(ring_directives()))
        log(f"deployment BH={BH} S={seq}: two rings and flash in "
            f"{run_s:.3f} s (host clock, first calls)")
        heads = flash_attention_ref(fq[:2], fk[:2], fv[:2], causal=True)
        for key, got in outs.items():
            for name, ref in (("flash", flash), ("oracle, 2 heads", heads)):
                reading, _ = _close(f"deployment ring {key} vs {name}",
                                    gathered(got)[:ref.shape[0]], ref, 1e-4)
                log(f"deployment ring {key} vs {name} BH={BH} S={seq} "
                    f"hd={w.hd}: {_reading(reading, 1e-4)}")
        del flash, heads
    bench = Bench(device, iters)
    n, _, Sl, hd = q.shape
    lib = ("sdpa", bench.ms(lambda: _sdpa(fq, fk, fv, True)))
    records = []
    for key in DEPLOY_VARIANTS:
        knobs = ra.VARIANTS[key]
        records.append(bench.record(
            f"ring_attention/{key}", f"n={n} BH={BH} Sl={Sl} hd={hd} f32",
            lambda: ra.ring_attention(q, k, v, **knobs),
            lambda: ra.ring_attention_plain(q, k, v, **knobs), 1e-4,
            attn_bound(BH, seq, hd, True), lib, RING_SOURCE, RING_REPLACES,
            ("ring_attention", key, n, BH, Sl, hd), "ring_main",
            got=outs.pop(key)))
    return counts, records


# ------------------------------------------- the slow path and the MoE engine


def slow_workload(small=False):
    """The slow path's workload: ``ServingStep(n_dev=4)`` at DeepSeek-V3
    width (d = 7168, f = fs = 2048; ``small``: test size)."""
    from repro_torch.workloads.serving import ServingStep
    if small:
        return ServingStep(n_dev=4, tokens_per_rank=16, d=64, f=64,
                           f_shared=64)
    return ServingStep(n_dev=4)


def store_path():
    """Where ``slow_main`` saves its search store: ``build/`` of the
    checkout (gitignored)."""
    path = ROOT / "build" / "repro_torch" / "slow_main_store.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def _generation_lines(res):
    """Per generation of a slow-path run: best score, the least
    ``t_wall_ms`` the card measured among its level-3 candidates (a
    cached result carries none) and rejections by class."""
    import collections
    for g in sorted({c.gen for c in res.db.records}):
        cands = [c for c in res.db.records if c.gen == g]
        done = [c for c in cands if c.result is not None and c.result.ok]
        walls = [c.result.t_wall_ms for c in done if not c.cached]
        best = max((c.score for c in done), default=0.0)
        rej = collections.Counter(c.result.rejection for c in cands
                                  if c.result is not None
                                  and c.result.rejection)
        log(f"slow_path gen {g}: {len(cands)} candidates "
            f"({sum(c.cached for c in cands)} from cache), {len(done)} at "
            f"level 3, best score {best:.3f}, best t_wall_ms "
            f"{min(walls) if walls else float('nan'):.4f}; rejections "
            f"{dict(rej)}")


def phase_slow_main(device="cuda", workload=None):
    """The slow path on the card, counted: ``fast_path`` then ``slow_path``
    on ``ServingStep(n_dev=4)`` at DeepSeek-V3 width,
    ``SlowPathConfig(islands=3, generations=4, seed=0)``, through the
    card's evaluator (``wallclock=True``), with the moe counter at 0.
    Every candidate that passes l0 and l1 must reach level 3 (no ``l2:*``
    rejection, no evaluator error or quarantine), the kernel must have
    been launched and the best score must be at least the seed's. The
    store is saved and a 2-generation warm start from it must serve
    directives from cache (its fingerprints match). Returns the moe
    launch counter of the cold search."""
    from repro_torch.core import SlowPathConfig, slow_path
    from repro_torch.core.cascade import CascadeEvaluator
    from repro_torch.core.fast_path import fast_path
    from repro_torch.core.hardware import H100, extract_hardware_context
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import moe_dispatch as kern
    w = workload or slow_workload()
    mesh = VirtualMesh(w.n_dev, device=device)
    hw = extract_hardware_context(mesh, H100)
    ev = CascadeEvaluator(w, mesh, hw, wallclock=True)
    store = store_path()
    kern.reset_launches()
    t0 = time.perf_counter()
    seed = fast_path(w, mesh, hw, evaluator=ev)
    res = slow_path(seed, mesh, hw, SlowPathConfig(islands=3, generations=4,
                                                   seed=0),
                    evaluator=ev, save_to=str(store))
    wall = time.perf_counter() - t0
    counts = dict(kern.LAUNCHES)
    _contexts_seen("slow_main", [kern])
    evaluated = len(ev.records)
    log(f"slow_path {w.name} n={w.n_dev} d={w.d} f={w.f} fs={w.f_shared}: "
        f"{evaluated} candidates evaluated (fast path included) in "
        f"{wall:.1f} s, {wall / evaluated:.3f} s per candidate; kernel "
        f"launches {sum(counts.values())}")
    _generation_lines(res)
    bad = [r for r in ev.records if r.rejection.startswith("l2")
           or r.rejection in ("error", "quarantine")]
    for r in bad:
        log(f"slow_path rejected on the card: {r.rejection} {r.directive}: "
            f"{r.diagnostic[-300:]}")
    if bad:
        raise SystemExit(f"slow_path: {len(bad)} candidates passed l0 and "
                         "l1 but not l2 on the card")
    if torch.device(device).type == "cuda" and not counts:
        raise SystemExit("slow_path launched no moe_dispatch kernel")
    if res.best.score < res.seed_score:
        raise SystemExit(f"slow_path best {res.best.score} < seed "
                         f"{res.seed_score}")
    summary = res.telemetry.payload()
    log(f"slow_path best: score {res.best.score:.3f} (seed "
        f"{res.seed_score:.3f}) t_wall_ms {res.best.result.t_wall_ms:.4f} "
        f"directive {res.best.directive!r}")
    log("slow_path telemetry: " + json.dumps(
        {k: summary[k] for k in ("schema", "workload", "scale", "totals",
                                 "mutations")}, sort_keys=True))
    ev2 = CascadeEvaluator(w, mesh, hw, wallclock=True)
    warm = slow_path(seed, mesh, hw, SlowPathConfig(islands=3, generations=2,
                                                    seed=0),
                     evaluator=ev2, warm_start=str(store))
    scale = warm.telemetry.payload()["scale"]
    log(f"slow_path warm start from {store.name}: {scale}; "
        f"{len(ev2.records)} candidates re-run through the cascade")
    _generation_lines(warm)
    if not scale["warm_start"] or scale["cache_hits"] <= 0 \
            or scale["transferred_seeds"]:
        raise SystemExit(f"slow_path warm start missed its cache: {scale}")
    return counts


def moe_engine_config(small=False):
    """The model ``serve_moe`` serves: llama4-maverick at every published
    width (d_model 5120, 40 heads, 8 KV heads, head_dim 128, expert d_ff
    8192, dense d_ff 16384, shared expert, vocab 202048, top-1, capacity
    1.25, bf16) with two cuts: depth one repeat unit (4 layers, 2 of them
    MoE) and 4 experts, one per rank of a 4-rank data mesh (the kernel
    takes one expert per rank, at most 8 ranks); ``small``: the reduced
    test size with the same cuts."""
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch("llama4-maverick-400b-a17b")
    if small:
        return reduced(cfg, num_experts=4, experts_per_token=1, pad_to=2)
    return dataclasses.replace(cfg, num_layers=4, num_experts=4, pad_to=4)


def moe_serve_shape(small=False):
    """(batch, prompt tokens, new tokens) of ``serve_moe``: the batch is a
    multiple of the 4 data ranks."""
    return (8, 16, 4) if small else (8, 512, 32)


def moe_call_shapes(cfg, shape, n=4):
    """``(label, T_local, C)`` of the kernel's two calls in the engine:
    prefill (B / n prompts a rank) and decode (B / n tokens a rank), C =
    ceil(capacity_factor * T_local * k / E)."""
    from repro_torch.models.moe import _capacity
    batch, prompt, _ = shape
    out = []
    for label, T in (("prefill", batch // n * prompt), ("decode", batch // n)):
        out.append((label, T, _capacity(T, cfg.experts_per_token,
                                         cfg.num_experts,
                                         cfg.capacity_factor)))
    return out


# ------------------------------------------------------------ the window

WINDOW_CONTEXTS = (1, 2, 4)
WINDOW_KERNELS = ("moe_dispatch", "kv_shuttle", "gemm_allgather",
                  "ring_attention")


def _moe_window_cells(device, small=False):
    """``(label, x, w1, w2, counts, shared, block_tokens, variants)`` of
    the moe cells the window phase runs: every variant on the serving and
    skewed cells; FLUX's (tile-fused) on the dropped rank's n = 3 cells
    and at the llama4 engine's prefill and decode shapes."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import moe_dispatch as moe
    for w in main_path_workloads(small):
        ins = w.example_inputs(0, VirtualMesh(w.n_dev, device=device))
        yield (f"{w.name} n={w.n_dev} d={w.d}", *ins[:3],
               [int(c) for c in w._counts(ins[0].shape[1])],
               (ins[0], *ins[3:]) if w.second_stream else None, 64,
               moe.VARIANTS)
    fused = {"tile_fused": moe.VARIANTS["tile_fused"]}
    for w in fault_workloads(small)[:2]:
        dw = w.degrade((0, 2, 3))
        ins = fault_inputs(dw, device)
        yield (f"{dw.name} n=3 (dropped rank 1)", *ins[:3],
               [int(c) for c in dw._counts(ins[0].shape[1])],
               (ins[0], *ins[3:]) if dw.second_stream else None, 64, fused)
    cfg = moe_engine_config(small)
    n, d, f = 4, cfg.d_model, cfg.moe_d_ff
    for label, T, C in moe_call_shapes(cfg, moe_serve_shape(small), n):
        g = torch.Generator(device=device).manual_seed(T)
        kw = dict(generator=g, device=device, dtype=torch.float32)
        x = torch.randn((n, n * C, d), **kw)
        w1 = torch.randn((n, d, 2 * f), **kw) / d ** 0.5
        w2 = torch.randn((n, f, d), **kw) / f ** 0.5
        shared = (torch.randn((n, T, d), **kw),
                  torch.randn((d, 2 * f), **kw) / d ** 0.5,
                  torch.randn((f, d), **kw) / f ** 0.5)
        yield (f"llama4_{label} d={d}", x, w1, w2, [C] * n, shared,
               min(64, C), fused)


def _window_cases(device, small=False):
    """``(kernel, variant, shape text, run(contexts), plain, tol,
    logged(contexts) or None)`` for every cooperative variant at PERF.md
    §4's shapes: moe_dispatch's variants on the serving and skewed cells
    (FLUX's on the n = 3 cells and the llama4 engine's two shapes),
    kv_shuttle's at KVTransfer's width and the engine's handoff,
    gemm_allgather's at GemmAllGather's defaults and the dropped rank's
    n = 3 slab (683 two-row chunks), the ring's at RingAttention's
    defaults (bf16 too), fig3's row and n = 3 (683 two-row chunks).
    ``logged`` runs the probe build and returns its checked summary."""
    from repro_torch.kernels import gemm_allgather as ga
    from repro_torch.kernels import kv_shuttle as kv
    from repro_torch.kernels import moe_dispatch as moe
    from repro_torch.kernels import ring_attention as ra
    probe_moe = ("tile_fused", "deferred_signal")
    for label, x, w1, w2, counts, shared, B, variants in _moe_window_cells(
            device, small):
        d = x.shape[2]
        for name, knobs in variants.items():
            kw = dict(counts=counts, shared=shared, block_tokens=B, **knobs)

            def logged(c, kw=kw):
                out, events, starts = moe.moe_dispatch_logged(
                    x, w1, w2, contexts=c, **kw)
                return moe.check_log(events, starts, moe.make_schedule(
                    counts, B), d=d, contexts=c, tile_fused=kw.get(
                        "tile_fused", False), shared=shared is not None)
            yield ("moe_dispatch", name, label,
                   lambda c, kw=kw: moe.moe_dispatch_combine(
                       x, w1, w2, contexts=c, **kw),
                   lambda kw=kw: moe.moe_dispatch_combine_ref(
                       x, w1, w2, counts=counts, block_tokens=B,
                       shared=shared, wire_i8=kw.get("wire_i8", False)),
                   1e-3 if knobs.get("wire_i8") else 1e-4,
                   logged if name in probe_moe else None)
        del x, w1, w2, shared
    w = kv_workload(small)
    x, wk, wv = kv_inputs(w, device)
    for name, knobs in kv.VARIANTS.items():
        def logged(c, knobs=knobs):
            *_, events, meta = kv.kv_shuttle_logged(x, wk, wv, contexts=c,
                                                    **knobs)
            return kv.check_log(events, **meta)
        yield ("kv_shuttle", name, f"T={w.T} d={w.d} dk={w.dk}",
               lambda c, knobs=knobs: kv.kv_shuttle(x, wk, wv, contexts=c,
                                                    **knobs),
               lambda knobs=knobs: kv.kv_shuttle_plain(x, wk, wv, **knobs),
               1e-4, logged if name in ("sequential", "fused_counter")
               else None)
    cfg = engine_config(small)
    batch, prompt, new = serve_shape(small)
    rows = cache_rows(cfg, batch, prompt + new + 1)
    g = torch.Generator(device=device).manual_seed(1)
    cache = torch.zeros((2, 2 * rows, cfg.hd), dtype=torch.bfloat16,
                        device=device)
    cache[0] = torch.randn((2 * rows, cfg.hd), generator=g, device=device)
    for name, knobs in kv.PURE_VARIANTS.items():
        def logged(c, knobs=knobs):
            *_, events, meta = kv.kv_shuttle_logged(cache, pure=True,
                                                    contexts=c, **knobs)
            return kv.check_log(events, **meta)
        yield ("kv_shuttle", "pure_" + name, f"rows={rows} width={cfg.hd} "
               "bf16", lambda c, knobs=knobs: kv.kv_cache_shuttle(
                   cache, contexts=c, **knobs),
               lambda knobs=knobs: kv.kv_shuttle_plain(cache, pure=True,
                                                       **knobs),
               "exact", logged)
    del x, wk, wv, cache
    w = ga_workload(small)
    for (a, b), label, variants in (
            (ga_inputs(w, device), f"n={w.n_dev} M={w.M} K={w.K} N={w.N}",
             ga.VARIANTS),
            (_ga_n3_inputs(w, device), "n=3 (dropped rank 1)",
             {"fused_counter_tm2": dict(fused=True, counter=True,
                                        tile_m=2)})):
        n, M_l, _ = a.shape
        N = b.shape[1]
        for name, knobs in variants.items():
            def logged(c, knobs=knobs, a=a, b=b, n=n, M_l=M_l, N=N):
                _, events = ga.gemm_allgather_logged(a, b, contexts=c,
                                                     **knobs)
                return ga.check_log(events, n=n, M_l=M_l, N=N, contexts=c,
                                    **knobs)
            yield ("gemm_allgather", name, f"{label} M_l={M_l}",
                   lambda c, knobs=knobs, a=a, b=b: ga.gemm_allgather(
                       a, b, contexts=c, **knobs),
                   lambda a=a, b=b: ga.gemm_allgather_plain(a, b), 1e-4,
                   logged if name in ("deferred", "fused_counter",
                                      "fused_counter_tm2") else None)
    w = ring_workload(small)
    (dBH, dseq) = deploy_shape(small)
    ring_cases = [(ring_inputs(w, device), "defaults", dict(ra.VARIANTS)),
                  (tuple(t.bfloat16() for t in ring_inputs(w, device)),
                   "defaults bf16", dict(ra.BF16_VARIANTS)),
                  (ring_inputs(w, device, BH=dBH, seq=dseq), "fig3 row",
                   {k: ra.VARIANTS[k] for k in DEPLOY_VARIANTS}),
                  (_ring_n3_inputs(w, device), "n=3 (dropped rank 1)",
                   {"fused_counter_kc2": dict(fused=True, counter=True,
                                              kv_chunk=2)})]
    probe_ring = ("fused_counter", "fused_signal", "pipelined",
                  "fused_counter_kc2")
    for (q, k, v), label, variants in ring_cases:
        n, BH, Sl, hd = q.shape
        for name, knobs in variants.items():
            def logged(c, knobs=knobs, q=q, k=k, v=v, n=n, Sl=Sl):
                _, events, cta0 = ra.ring_attention_logged(
                    q, k, v, contexts=c, **knobs)
                return ra.check_log(events, cta0, n=n, Sl=Sl, contexts=c,
                                    **knobs)
            yield ("ring_attention", name, f"{label} n={n} BH={BH} Sl={Sl} "
                   f"hd={hd}", lambda c, knobs=knobs, q=q, k=k, v=v:
                   ra.ring_attention(q, k, v, contexts=c, **knobs),
                   lambda knobs=knobs, q=q, k=k, v=v: ra.ring_attention_plain(
                       q, k, v, **knobs),
                   "bf16" if q.dtype == torch.bfloat16 else 1e-4,
                   logged if label != "fig3 row" and name in probe_ring
                   else None)


def _ga_n3_inputs(w, device):
    """The dropped rank's gemm_allgather slab: ``w`` degraded onto the
    survivors of rank 1."""
    return ga_inputs(w.degrade((0, 2, 3)), device, seed=3)


def _ring_n3_inputs(w, device):
    """The dropped rank's ring: ``w`` degraded onto the survivors of rank
    1."""
    return ring_inputs(w.degrade((0, 2, 3)), device, seed=3)


def phase_window(device="cuda", iters=5, small=False):
    """The send window on the card (``csrc/window.cuh``): every cooperative
    variant of :func:`_window_cases` at contexts 1, 2 and 4, each output
    held to its plain version under the kernel phases' gates and timed
    (L2 flushed), one ``window:`` line a kernel, variant and contexts; for
    the probed variants the probe build (``-DCUCO_PROBE``) logs every
    CTA's window at the full grid and the kernel's ``check_log`` holds it
    (depth profile equal to ``send_window_depths``, drained at every drain
    point, rounds in the schedule's order, the rank's rounds all there,
    receive waits equal to ``completion_ticks``): the line carries its
    summary. Then gemm_allgather at one CTA a rank against the copied
    ``ScheduleProbe.check``: it must pass where a card tile is the
    schedule's round (N = 128, tile_m = 128), and at GemmAllGather's
    defaults the check's divergence (a tile is a piece of a row of the
    schedule's rounds) is printed as the gap it is. Returns the lines'
    numbers: ``{(kernel, variant, shape): {contexts: ms}}``."""
    from repro_torch.core.schedule import make_broadcast_schedule
    from repro_torch.core.trace import ScheduleProbe
    from repro_torch.kernels import build, window
    from repro_torch.kernels import gemm_allgather as ga
    cuda = torch.device(device).type == "cuda"
    if cuda:
        t0 = time.perf_counter()
        build.build(WINDOW_KERNELS, window.PROBE_DEFINES)
        log(f"window: probe builds ({' + '.join(WINDOW_KERNELS)}, "
            f"-D{window.PROBE_DEFINES[0]}) in {time.perf_counter() - t0:.1f} s")
    bench = Bench(device, iters)
    times = {}
    for kernel, variant, shape, run, plain, tol, logged in _window_cases(
            device, small):
        with torch.no_grad():
            want = plain()
            row = times.setdefault((kernel, variant, shape), {})
            for c in WINDOW_CONTEXTS:
                got = run(c)
                if cuda:
                    torch.cuda.synchronize(device)
                reading, _ = _close(f"window {kernel}/{variant} contexts={c}",
                                    got, want, tol)
                del got
                row[c] = bench.ms(lambda: run(c))
                probe = ""
                if logged is not None and cuda:
                    s = logged(c)
                    probe = (f"; probe log of {s['ctas']} CTAs, {s['rounds']}"
                             f" rounds: max depth {s['max_depth']}, drained, "
                             "in order -> ok")
                log(f"window: {kernel} {variant} {shape} contexts={c}: "
                    f"{row[c]:.3f} ms, {_reading(reading, tol)}{probe}")
        del want
    if not cuda:
        log("window: the one-CTA-a-rank check is a probe build: skipped on "
            "the cpu")
        return times
    for label, (M_l, K, N) in (("tile = round", (1024, 4096, 128)),
                               ("defaults", (1024, 4096, 4096))):
        g = torch.Generator(device=device).manual_seed(5)
        a = torch.randn((4, M_l, K), generator=g, device=device)
        b = torch.randn((K, N), generator=g, device=device) / K ** 0.5
        for c in WINDOW_CONTEXTS:
            probe = ScheduleProbe()
            out = ga.gemm_allgather(a, b, tile_m=128, fused=True,
                                    counter=True, contexts=c, probe=probe)
            _close("gemm_allgather one CTA a rank", out,
                   ga.gemm_allgather_plain(a, b), 1e-4)
            sched = make_broadcast_schedule(4, M_l, 128, True)
            try:
                s = probe.check(sched, c, True)
                verdict = (f"passes ScheduleProbe.check: {s['rounds']} "
                           f"rounds, max depth {s['max_depth']}, "
                           f"{s['recv_waits']} receive waits")
            except AssertionError as err:
                if label == "tile = round":
                    raise SystemExit(f"window: gemm_allgather at one CTA a "
                                     f"rank fails the check: {err}")
                verdict = ("differs from the schedule, as a 128 x 128 tile "
                           "is a piece of a row of its rounds (ROADMAP §3): "
                           + str(err).splitlines()[0])
            log(f"window: gemm_allgather one CTA a rank ({label}, N={N}) "
                f"contexts={c}: {verdict}")
        del a, b
    return times


def phase_moe_model_kernels(device="cuda", cfg=None, shape=None, iters=5):
    """moe_dispatch at the MoE engine's two shapes (``moe_call_shapes``:
    prefill and decode, ``block_tokens = min(64, C)``), the knobs
    ``_pallas_body`` launches (tile-fused COUNTER, pipelined, the shared
    expert as second stream), on inputs from a seed: held against the
    plain version within 1e-4 and timed beside the same GEMMs'
    ``torch.matmul`` and the bound. At the decode shape it also takes the
    kernel's time apart: every (source, expert) pair's one-row microblock
    is a segment of its own, so each expert's weights are read once a
    source, and each segment (and each rank's shared-expert rows) runs a
    whole 64-row tile. The ``decode tiles:`` line times the same tile work
    with each weight read once: ``gemm_core`` over one expert's n tiles
    stacked (n * 64 rows: GEMM1 with SwiGLU, then GEMM2), once for each
    expert and the shared expert, beside the kernel. Returns one record
    per shape; the launches come from ``serve_moe``."""
    from repro_torch.kernels.moe_dispatch import TILE, gemm_core
    cfg = cfg or moe_engine_config()
    shape = shape or moe_serve_shape()
    bench = Bench(device, iters)
    n, d, f = 4, cfg.d_model, cfg.moe_d_ff
    out = []
    for label, T, C in moe_call_shapes(cfg, shape, n):
        g = torch.Generator(device=device).manual_seed(T)
        kw = dict(generator=g, device=device, dtype=torch.float32)
        x = torch.randn((n, n * C, d), **kw)
        w1 = torch.randn((n, d, 2 * f), **kw) / d ** 0.5
        w2 = torch.randn((n, f, d), **kw) / f ** 0.5
        shared = (torch.randn((n, T, d), **kw),
                  torch.randn((d, 2 * f), **kw) / d ** 0.5,
                  torch.randn((f, d), **kw) / f ** 0.5)
        counts, B = [C] * n, min(64, C)
        out.append(moe_record(
            bench, f"llama4_{label}", x, w1, w2, counts, shared,
            dict(tile_fused=True, pipelined=True), B,
            moe_bound(n, counts, d, f, f, T, xs_is_x=False),
            moe_library(bench, x, w1, w2, counts, shared), "serve_moe"))
        if label == "decode":
            # one expert's n segments (one shared-expert tile a rank) as
            # n stacked 64-row tiles, its weights read once
            a = torch.randn((n * TILE, d), **kw)
            h = torch.randn((n * TILE, f), **kw)
            g1 = bench.ms(lambda: gemm_core(a, w1[0], swiglu=True))
            g2 = bench.ms(lambda: gemm_core(h, w2[0]))
            tiles = n * n * -(-C // B) + n * -(-T // TILE)
            gflop = tiles * TILE * 6 * d * f / 1e9
            gb = 4 * 3 * d * f / 1e9
            log(f"decode tiles: {n} sources x {n} experts one-row microblocks "
                f"+ {n} ranks' shared rows run {tiles} tiles of {TILE} rows "
                f"for {n * n * C + n * T} rows: {gflop:.1f} GFLOP of tile "
                f"work; the same tiles with each weight read once "
                f"(gemm_core over {n * TILE} rows, GEMM1 {g1:.3f} + GEMM2 "
                f"{g2:.3f} ms, x {n + 1} weights) {(n + 1) * (g1 + g2):.3f} "
                f"ms, against the kernel's {out[-1]['ms']:.3f} ms, which "
                f"reads each weight once a segment: {tiles * gb:.2f} GB "
                f"against {(n + 1) * gb:.2f} GB once")
            del a, h
        del x, w1, w2, shared
    return out


def _bf16_step(v):
    """The gap between neighbouring bf16 values at magnitude ``v`` (8
    significant bits)."""
    return math.ldexp(1.0, math.frexp(v)[1] - 8) if v else 0.0


def phase_serve_moe(device="cuda", cfg=None, shape=None):
    """The MoE engine at full width (``moe_engine_config``; its two cuts
    are listed there), counted: weights from seed 0; a ``VirtualMesh(4)``
    data mesh; 8 prompts of 512 tokens; ``generate`` 32 tokens with
    ``StepOptions(moe_backend="pallas", moe_overlap=True)`` after a
    warm-up on an engine of its own. It must hold:

    * the moe counter reads MoE layers x (1 prefill + 31 decode steps);
    * against the same engine with ``moe_backend="xla"`` (the all-to-all
      body on the card's operators): on the pallas engine's token stream
      the two backends' logits agree within 5e-2 (max-abs-normalised,
      bf16) at every step, and the pallas engine replays its own tokens.
      Both compute the MoE in f32 and round it to bf16, so they differ
      only where f32 sums taken in another order round to neighbouring
      bf16 values; the free-running greedy streams are equal up to their
      first split, and there the xla pick leads the pallas token by at
      most one bf16 step at that logit size (a tie that such a rounding
      tips);
    * the first decode step's logits are within 5e-2 (max-abs-normalised,
      bf16) of ``forward`` over the 513 tokens. That holds where no token
      is dropped: a decode step routes 2 tokens a rank at capacity
      ceil(1.25 * 2 / 4) = 1, a forward over 513 tokens 1026 at 321, so at
      the config's capacity the capacity rule drops different tokens in
      the two and they are different functions. The check runs at
      capacity 4, where C >= T_local and no token can drop; the reading
      at 1.25 is printed beside it;
    * ``serve`` answers 4 requests of one prompt length with
      ``Scheduler(max_batch=4)``, so every batch shards over the 4 ranks,
      and its tokens equal ``generate``'s for the same prompts.

    Prints prefill ms, decode ms per step and tokens/s (host clock after a
    synchronize). Returns the moe launch counter of the ``generate``."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.dist.sharding import Rules
    from repro_torch.kernels import moe_dispatch as kern
    from repro_torch.models import (StepOptions, decode_step, forward,
                                    init_params, prefill_step)
    from repro_torch.models.model import lm_logits, with_kernel_weights
    from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
    cfg = cfg or moe_engine_config()
    batch, prompt, new = shape or moe_serve_shape()
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    g = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                           device=device)
    sync()
    log(f"serve_moe {cfg.name}: {cfg.num_layers} layers ({n_moe} MoE, "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token}, capacity "
        f"{cfg.capacity_factor}) d={cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} expert d_ff {cfg.moe_d_ff} "
        f"dense d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}; "
        f"{cfg.param_count() / 1e9:.2f} B parameters from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    rules = Rules(VirtualMesh(4, device=device, axis="data"), "decode")
    b = {"tokens": tokens}
    max_seq = prompt + new + 1

    def engine(backend):
        return Engine(cfg, params, ServeConfig(
            max_seq=max_seq, opts=StepOptions(moe_backend=backend,
                                              moe_overlap=True)),
                      rules=rules)

    def timed_generate(eng, what):
        t0 = time.perf_counter()
        toks = eng.generate(what, new)
        sync()
        gen_s = time.perf_counter() - t0
        snap = eng.metrics.snapshot()["histograms"]
        return toks, gen_s, snap["serve.prefill_ms"]["mean"], \
            snap["serve.decode_step_ms"]["mean"]

    # warm-up on an engine of its own: kernel loading and the BLAS
    # handles' set-up stay out of the timed engine's metrics
    engine("pallas").generate(b, 2)
    eng = engine("pallas")
    kern.reset_launches()
    toks, gen_s, pre_ms, dec_ms = timed_generate(eng, b)
    counts = dict(kern.LAUNCHES)
    _contexts_seen("serve_moe", [kern], {2})
    want = n_moe * new if cuda else 0
    log(f"serve_moe generate (pallas): {batch} x {prompt} prompt tokens -> "
        f"{new} new in {gen_s:.3f} s; prefill {pre_ms:.3f} ms "
        f"({batch * prompt / pre_ms * 1e3:.0f} prompt tok/s), decode "
        f"{dec_ms:.3f} ms/step ({batch / dec_ms * 1e3:.0f} tok/s); moe "
        f"launches {counts}")
    if sum(counts.values()) != want:
        raise SystemExit(f"serve_moe launched moe_dispatch "
                         f"{sum(counts.values())} times, not {n_moe} MoE "
                         f"layers x {new} steps = {want}")
    xla = engine("xla")
    xla_toks, xla_s, xla_pre, xla_dec = timed_generate(xla, b)
    split = (toks != xla_toks).nonzero()
    log(f"serve_moe generate (xla body): prefill {xla_pre:.3f} ms, decode "
        f"{xla_dec:.3f} ms/step; free-running greedy tokens equal the "
        f"pallas engine's: {not len(split)}"
        + (f" (first apart at (row, step) {split[0].tolist()})"
           if len(split) else ""))

    lp = _forced_logits(eng, b, toks, prompt)
    lx = _forced_logits(xla, b, toks, prompt)
    del xla
    step_err = _hold_streams("serve_moe pallas vs xla", toks, lp, xla_toks,
                             lx)
    log(f"serve_moe pallas vs xla on the pallas token stream: logits within "
        f"rel err {float(step_err.max()):.3e} of each other at every step "
        f"(worst step {int(step_err.argmax())}; tol {LOGIT_TOL:.0e}; "
        f"largest logit {float(lp.abs().max()):.3f})")
    del lp, lx
    readings = {}
    for cap in (cfg.capacity_factor, 4.0):
        ccfg = dataclasses.replace(cfg, capacity_factor=cap)
        kp = with_kernel_weights(params, ccfg)
        opts = StepOptions(moe_backend="pallas", moe_overlap=True)
        with torch.no_grad():
            pl, cache = prefill_step(kp, b, ccfg, rules, seq_len=max_seq,
                                     opts=opts)
            first = torch.argmax(pl[:, -1], dim=-1)
            dl, _ = decode_step(kp, cache, first[:, None], prompt, ccfg,
                                rules, opts=opts)
            grown = torch.cat([tokens, first[:, None]], 1)
            x, _ = forward(kp, {"tokens": grown}, ccfg, rules, opts)
            fl = lm_logits(kp, x[:, -1:], ccfg)[..., :cfg.vocab_size]
            dl = dl[..., :cfg.vocab_size]
        del kp, cache, x
        if cap == 4.0:
            readings[cap], _ = _close("moe decode logits vs forward", dl, fl,
                                      LOGIT_TOL)
        else:
            readings[cap] = float((dl - fl).abs().max()
                                  / (fl.abs().max() + 1e-9))
    log(f"serve_moe decode step vs forward over {prompt + 1} tokens: logits "
        f"{tuple(dl.shape)} (the real vocab), "
        f"{_reading(readings[4.0], LOGIT_TOL)} at capacity "
        f"4 (no token can drop); rel err {readings[cfg.capacity_factor]:.3e} "
        f"at the config's {cfg.capacity_factor} (not held: decode and "
        f"forward drop different tokens)")
    sched = Scheduler(token_budget=4 * prompt, max_batch=4,
                      metrics=eng.metrics)
    for rid in range(4):
        sched.submit(Request(rid, tokens[rid].tolist(),
                             max_new_tokens=max(2, new // 4)))
    t0 = time.perf_counter()
    done = eng.serve(sched)
    sync()
    serve_s = time.perf_counter() - t0
    four = eng.generate({"tokens": tokens[:4]}, max(2, new // 4))
    equal = sorted(done) == list(range(4)) and all(
        torch.equal(done[r].to(four.device), four[r]) for r in range(4))
    log(f"serve_moe scheduler: {len(done)} of 4 requests of {prompt} tokens "
        f"done in {serve_s:.3f} s; tokens equal generate's: {equal}")
    if not equal:
        raise SystemExit("serve_moe: serve's tokens differ from generate's")
    return counts



# ------------------------------------------------ the fault loop on the card


def fault_plans():
    """The reference's fault suite's two plans: rank 1 dropped, and rank 2
    a straggler whose DMAs land 100 us late for 8 rounds."""
    from repro_torch.core.faults import (DROPPED_PEER, STRAGGLER, FaultPlan,
                                         FaultSpec)
    return (FaultPlan("drop-rank-1", (FaultSpec(DROPPED_PEER, rank=1),)),
            FaultPlan("straggler-8x100us", (FaultSpec(
                STRAGGLER, rank=2, rounds=8, delay_s=100e-6),)))


def fault_workloads(small=False):
    """The five workloads at their defaults, in the fault suite's order
    (``small``: test size)."""
    from repro_torch.workloads.gemm_allgather import GemmAllGather
    from repro_torch.workloads.kv_transfer import KVTransfer
    from repro_torch.workloads.moe_dispatch import MoEDispatch
    from repro_torch.workloads.ring_attention import RingAttention
    from repro_torch.workloads.serving import ServingStep
    if small:
        return [MoEDispatch(n_dev=4, tokens_per_rank=256, d=64, f=128),
                ServingStep(n_dev=4, tokens_per_rank=64, d=64, f=64,
                            f_shared=64),
                GemmAllGather(M=256, K=64, N=48),
                RingAttention(BH=2, seq=512, hd=16),
                KVTransfer(T=128, d=64, dk=32)]
    return [MoEDispatch(), ServingStep(), GemmAllGather(), RingAttention(),
            KVTransfer()]


def fault_inputs(w, device, seed=0):
    """The inputs a fault-phase cascade verifies and a kernel record runs
    on: gemm_allgather and the ring at their full width (a (n, M_l, K) and
    b; q, k, v (n, BH, Sl, hd)), the MoE workloads and kv_transfer at
    their ``example_inputs`` (256 tokens a rank; T <= 128)."""
    from repro_torch.dist.mesh import VirtualMesh
    if w.name == "gemm_allgather":
        return ga_inputs(w, device, seed)
    if w.name == "ring_attention":
        return ring_inputs(w, device, seed)
    return w.example_inputs(1234, VirtualMesh(w.n_dev, device=device))


def _flux_call(w, ins):
    """``(run, plain, knobs)``: workload ``w``'s FLUX point as a direct
    call of its kernel and of the kernel's plain version on ``ins``, with
    the knobs its build passes."""
    from repro_torch.core.design_space import EXPERT_SYSTEMS
    flux = EXPERT_SYSTEMS["FLUX"]
    if w.name == "gemm_allgather":
        from repro_torch.kernels import gemm_allgather as kern
        k = w.kernel_knobs(flux, ins[0].shape[1])
        knobs = dict(fused=k["fused"], counter=k["counter"],
                     tile_m=k["tile_m"])
        return (lambda: kern.gemm_allgather(*ins, **knobs),
                lambda: kern.gemm_allgather_plain(*ins, **knobs), knobs)
    if w.name == "ring_attention":
        from repro_torch.kernels import ring_attention as kern
        k = w.kernel_knobs(flux)
        knobs = dict(fused=k["fused"], counter=k["counter"],
                     kv_chunk=k["kv_chunk"], pipelined=k["pipelined"],
                     eager_wait=k["eager"])
        return (lambda: kern.ring_attention(*ins, **knobs),
                lambda: kern.ring_attention_plain(*ins, **knobs), knobs)
    from repro_torch.kernels import moe_dispatch as kern
    k = w.kernel_knobs(flux)
    knobs = dict(tile_fused=k["tile_fused"], pipelined=k["pipelined"],
                 barrier=k["barrier"], combine_tile=k["combine_tile"])
    x, w1, w2 = ins[:3]
    shared = (x, *ins[3:]) if w.second_stream else None
    kw = dict(counts=[int(c) for c in w._counts(x.shape[1])],
              block_tokens=k["block_tokens"], tight=k["tight"])
    return (lambda: kern.moe_dispatch_combine(x, w1, w2, shared=shared,
                                              **kw, **knobs),
            lambda: kern.moe_dispatch_combine_ref(x, w1, w2, shared=shared,
                                                  **kw),
            dict(knobs, block_tokens=k["block_tokens"]))


def _fault_record(bench, w, ins):
    """The kernels-line record of ``w``'s FLUX kernel on ``ins`` (held to
    its plain version at PERF.md's tolerances, timed beside its bound and
    library call); the launches come from the counted ``faults`` path."""
    run, plain, knobs = _flux_call(w, ins)
    if w.name == "gemm_allgather":
        from repro_torch.kernels.gemm_allgather import variant_name
        a, b = ins
        n, M_l, K = a.shape
        N = b.shape[1]
        sink = torch.empty((n, n * M_l, N), device=a.device)
        key = variant_name(M_l=M_l, **knobs)
        return bench.record(
            f"gemm_allgather/{key}", f"n={n} M_l={M_l} K={K} N={N} f32",
            run, plain, 1e-4, ga_bound(n, M_l, K, N),
            ("matmul+copy", bench.ms(lambda: sink.copy_(torch.matmul(
                a.reshape(-1, K), b)[None].expand_as(sink)))),
            GA_SOURCE, GA_REPLACES, ("gemm_allgather", key, n, M_l, K, N),
            "faults")
    if w.name == "ring_attention":
        from repro_torch.kernels.ring_attention import variant_name
        n, BH, Sl, hd = ins[0].shape
        key = variant_name(n=n, Sl=Sl, **knobs)
        whole = [gathered(t).contiguous() for t in ins]
        lib = ("sdpa", bench.ms(lambda: _sdpa(*whole, True)))
        del whole
        return bench.record(
            f"ring_attention/{key}", f"n={n} BH={BH} Sl={Sl} hd={hd} f32",
            run, plain, 1e-4, attn_bound(BH, n * Sl, hd, True), lib,
            RING_SOURCE, RING_REPLACES, ("ring_attention", key, n, BH, Sl,
                                         hd), "faults")
    x, w1, w2 = ins[:3]
    shared = (x, *ins[3:]) if w.second_stream else None
    counts = [int(c) for c in w._counts(x.shape[1])]
    block_tokens = knobs.pop("block_tokens")
    return moe_record(bench, f"{w.name}_n{w.n_dev}", x, w1, w2, counts,
                      shared, knobs, block_tokens, (*bound(w, counts), None),
                      moe_library(bench, x, w1, w2, counts, shared), "faults")


def _check_timeline(w, d, hw, *, live_ranks=None, plan=None):
    """Render one modeled timeline, validate it and hold its critical path
    to the cost it renders (``analytic_cost`` of the workload, degraded
    when ``live_ranks`` drop a rank, or ``fault_cost`` under ``plan``)
    within 1e-6 s. Returns (events, critical path s)."""
    from repro_torch.core.faults import fault_cost
    from repro_torch.core.trace import schedule_timeline, validate_trace
    tl = schedule_timeline(w, d, hw, live_ranks=live_ranks, plan=plan)
    events = validate_trace(tl.to_dict())
    if plan is not None:
        want = fault_cost(w, d, hw, plan)
    elif live_ranks is not None:
        want = w.degrade(live_ranks).analytic_cost(d, hw)
    else:
        want = w.analytic_cost(d, hw)
    if not abs(tl.critical_path_s - want) <= 1e-6:
        raise SystemExit(f"timeline {w.name} ({getattr(plan, 'name', live_ranks)}"
                         f"): critical path {tl.critical_path_s!r} s, cost "
                         f"{want!r} s")
    return events, tl.critical_path_s


STALL_US = 100             # the slowed rank's idle before each ring step


def _apart():
    """The degraded calls ``phase_faults`` times beside FLUX: the ring's
    pipelined rotation (one whole-shard round a step) and gemm_allgather's
    fused SIGNAL (one flag a source), neither cut into 2-row chunks."""
    from repro_torch.kernels import gemm_allgather as ga
    from repro_torch.kernels import ring_attention as ra
    return {"ring_attention": (ra.ring_attention, ra.VARIANTS["pipelined"]),
            "gemm_allgather": (ga.gemm_allgather,
                               ga.VARIANTS["fused_signal"])}


def phase_faults(device="cuda", workloads=None, iters=5):
    """The reference's fault suite on the card (``tests/scripts/
    fault_suite.py``), with every launch counter at 0 for the counted
    part. For each of the five workloads at its full default width:
    ``degrade`` onto the survivors of a dropped rank 1 (kv_transfer: the
    solo tier) and ``CascadeEvaluator`` on FLUX over a ``VirtualMesh`` of
    the survivors' width must reach level 3 (gemm_allgather and the ring
    verify on their full-width degraded inputs); ``fault_cost`` of the
    plan must be finite and above ``analytic_cost`` (H100 model); the
    modeled timelines (healthy, degraded, under each plan) must validate
    and match their costs within 1e-6 s. Then, on the ring: the straggler
    stall at contexts 1 above contexts 4 above 0 (model); a degraded ring
    evaluator under two more plans with ``fault_weight=1.0`` at level 3
    with both in its ``fault_report``. On kv_transfer's built program:
    ``CORRUPT_WIRE`` classified ``l2:nonfinite``, ``TRUNCATED_WIRE``
    ``l2:mismatch``; a wedged build (a Python sleep) quarantined at
    ``timeout_s`` and the next candidate scored to level 3. The counters
    are read there: moe_dispatch, gemm_allgather and the ring must show
    launches at n = 3. Then each of those kernels (both MoE workloads) is
    held to its plain version on the degraded inputs and timed (its
    kernels-line record), and timed at n = 4 on the healthy inputs, for
    one line a workload: modeled ms healthy and degraded beside the
    kernel's measured ms. Last, on the card, the straggler observation:
    the ring's test build with rank 2 idling ``STALL_US`` before each
    step, at contexts 1, 2 and 4, against the unslowed ring, beside
    ``fault_cost``'s modeled stall for that plan (printed, not held).
    Returns (the faults path's launch counter, the records)."""
    from repro_torch.core.cascade import Candidate, CascadeEvaluator
    from repro_torch.core.design_space import EXPERT_SYSTEMS, Directive
    from repro_torch.core.faults import (CORRUPT_WIRE, DROPPED_PEER,
                                         STRAGGLER, TRUNCATED_WIRE,
                                         FaultPlan, FaultSpec, fault_cost,
                                         inject_wire_fault)
    from repro_torch.core.hardware import H100, extract_hardware_context
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import gemm_allgather as ga
    from repro_torch.kernels import moe_dispatch as moe
    from repro_torch.kernels import ring_attention as ra
    flux = EXPERT_SYSTEMS["FLUX"]
    drop1, strag = fault_plans()
    cuda = torch.device(device).type == "cuda"
    ws = workloads or fault_workloads()

    def context(n):
        return extract_hardware_context(VirtualMesh(n, device=device), H100)

    for kern in (moe, ga, ra):
        kern.reset_launches()
    degraded = {}
    for w in ws:
        hw = context(w.n_dev)
        live = drop1.live_ranks(w.n_dev)
        dw = w.degrade(live)
        if dw.n_dev != len(live):
            raise SystemExit(f"{w.name} degraded to {dw.n_dev} ranks, not "
                             f"{len(live)}")
        ins = fault_inputs(dw, device, seed=2)
        ev = CascadeEvaluator(dw, VirtualMesh(dw.n_dev, device=device),
                              context(dw.n_dev), verify_inputs=ins)
        t0 = time.perf_counter()
        res = ev.evaluate(Candidate(flux, mutation="FLUX"))
        healthy_ms = w.analytic_cost(flux, hw) * 1e3
        degraded_ms = fault_cost(w, flux, hw, drop1) * 1e3
        log(f"faults {w.name}: {drop1.name} -> n={dw.n_dev}"
            f"{' (solo)' if getattr(dw, 'solo', False) else ''}; degraded "
            f"cascade FLUX level {res.level} in {time.perf_counter() - t0:.1f}"
            f" s, knobs {res.record.knobs}; modeled (H100 model) healthy "
            f"{healthy_ms:.6f} ms, under the plan {degraded_ms:.6f} ms")
        if res.level != 3:
            raise SystemExit(f"degraded {w.name} stopped at level "
                             f"{res.level}: {res.diagnostic}")
        if not (math.isfinite(res.t_model_ms) and math.isfinite(degraded_ms)
                and degraded_ms > healthy_ms):
            raise SystemExit(f"{w.name}: fault_cost {degraded_ms} ms is not "
                             f"finite above analytic_cost {healthy_ms} ms")
        events = 0
        for kw in ({}, {"live_ranks": live}, {"plan": drop1},
                   {"plan": strag}):
            events += _check_timeline(w, flux, hw, **kw)[0]
        log(f"faults {w.name}: 4 timelines (healthy, degraded, "
            f"{drop1.name}, {strag.name}), {events} events, valid, critical "
            f"paths equal their costs within 1e-6 s")
        degraded[w.name] = (w, dw, ins, healthy_ms, degraded_ms)

    # straggler: charged through window_stall_factor (model)
    ring = next(w for w in ws if w.name == "ring_attention")
    hw = context(ring.n_dev)
    shallow = Directive("PALLAS_RDMA", "COUNTER", "TILE_FUSED", "LOCAL",
                        "GRID_STEP", "PER_TILE", "ACQREL", 1)
    deep = dataclasses.replace(shallow, contexts=4)
    stall_1 = fault_cost(ring, shallow, hw, strag) - ring.analytic_cost(
        shallow, hw)
    stall_4 = fault_cost(ring, deep, hw, strag) - ring.analytic_cost(deep, hw)
    log(f"faults straggler {strag.name} on {ring.name} (H100 model): stall "
        f"{stall_1 * 1e3:.6f} ms at contexts 1, {stall_4 * 1e3:.6f} ms at "
        f"contexts 4")
    if not stall_1 > stall_4 > 0:
        raise SystemExit(f"straggler stall {stall_1} !> {stall_4} !> 0")
    _, rdw, rins, _, _ = degraded[ring.name]
    plans = (FaultPlan("drop-another", (FaultSpec(DROPPED_PEER, rank=2),)),
             strag)
    ev = CascadeEvaluator(rdw, VirtualMesh(rdw.n_dev, device=device),
                          context(rdw.n_dev), verify_inputs=rins,
                          fault_plans=plans, fault_weight=1.0)
    res = ev.evaluate(Candidate(flux, mutation="FLUX"))
    log(f"faults fault_report of the degraded ring (H100 model): level "
        f"{res.level} score {res.score:.3f} fault_penalty_ms "
        f"{res.record.fault_penalty_ms:.6f}; "
        + ", ".join(f"{k}: {v['healthy_ms']:.6f} -> {v['degraded_ms']:.6f} "
                    f"ms survives {v['survives']}"
                    for k, v in res.fault_report.items()))
    if res.level != 3 or set(res.fault_report) != {p.name for p in plans} \
            or not all(e["survives"] for e in res.fault_report.values()):
        raise SystemExit(f"degraded ring under plans: level {res.level}, "
                         f"report {res.fault_report}: {res.diagnostic}")

    # wire faults on kv_transfer's built program, classified at l2
    kv = next(w for w in ws if w.name == "kv_transfer")
    kmesh = VirtualMesh(kv.n_dev, device=device)

    class FaultyWire(type(kv)):
        spec = None

        def build(self, d, mesh):
            fn = super().build(d, mesh)
            return lambda *xs: inject_wire_fault(fn(*xs), self.spec)

    fw = FaultyWire(T=kv.T, d=kv.d, dk=kv.dk)
    for spec, want in ((FaultSpec(CORRUPT_WIRE, rows=4), "l2:nonfinite"),
                       (FaultSpec(TRUNCATED_WIRE, rows=64), "l2:mismatch")):
        fw.spec = spec
        res = CascadeEvaluator(fw, kmesh, context(kv.n_dev)).evaluate(
            Candidate(flux, mutation=spec.kind))
        log(f"faults wire {spec.kind} rows={spec.rows} on {kv.name}: level "
            f"{res.level}, rejection {res.rejection!r}")
        if (res.level, res.rejection) != (1, want):
            raise SystemExit(f"{spec.kind}: level {res.level} rejection "
                             f"{res.rejection!r}, want 1 {want!r}: "
                             f"{res.diagnostic}")

    # a wedged build is quarantined; the evaluator scores the next one
    import threading
    release = threading.Event()
    wedge = type(kv)(T=kv.T, d=kv.d, dk=kv.dk)
    orig_build = wedge.build

    def wedged_build(d, mesh):
        if d.placement == "TILE_FUSED":
            def hang(*xs):
                release.wait(60.0)           # wedges the execution
                raise RuntimeError("wedged candidate released")
            return hang
        return orig_build(d, mesh)

    wedge.build = wedged_build
    ev = CascadeEvaluator(wedge, kmesh, context(kv.n_dev), timeout_s=2.0)
    t0 = time.perf_counter()
    res = ev.evaluate(Candidate(flux, mutation="wedged"))
    wedged_s = time.perf_counter() - t0
    release.set()
    nxt = ev.evaluate(Candidate(Directive(
        "PALLAS_RDMA", "SIGNAL", "STREAM_SPLIT", contexts=2),
        mutation="next"))
    log(f"faults wedge on {kv.name}: quarantined {res.quarantined} after "
        f"{wedged_s:.1f} s at {ev.quarantine_report()[0]['stage']!r}; the "
        f"next candidate level {nxt.level}")
    if not (res.quarantined and res.score == 0.0 and wedged_s < 30.0
            and len(ev.quarantine_report()) == 1 and nxt.level == 3):
        raise SystemExit(f"wedge: quarantined {res.quarantined}, next "
                         f"level {nxt.level}: {nxt.diagnostic}")

    counts = {**moe.LAUNCHES, **_prefixed("gemm_allgather", ga.LAUNCHES),
              **_prefixed("ring_attention", ra.LAUNCHES)}
    log(f"faults launches: {counts}")
    _contexts_seen("faults", [moe, ga, ra], {flux.contexts})
    if cuda:
        for what, kern in (("moe_dispatch", moe), ("gemm_allgather", ga),
                           ("ring_attention", ra)):
            # every key is (variant, n, ...)
            if not any(key[1] == 3 for key in kern.LAUNCHES):
                raise SystemExit(f"faults: {what} was not launched at n = 3")

    # the kernels on the degraded inputs, and at n = 4 for the summary
    bench = Bench(device, iters)
    apart = _apart()
    records = []
    for name in ("moe_dispatch", "serving_step", "gemm_allgather",
                 "ring_attention", "kv_transfer"):
        w, dw, ins, healthy_ms, degraded_ms = degraded[name]
        if name == "kv_transfer":
            log(f"faults summary {name}: modeled (H100 model) healthy "
                f"{healthy_ms:.6f} ms, degraded {degraded_ms:.6f} ms; the "
                "solo tier runs no kernel (kernel ms at n = 4 and n = 3 not "
                "measured: the workload has 2 ranks)")
            continue
        records.append(_fault_record(bench, dw, ins))
        hins = fault_inputs(w, device, seed=2)
        k4 = bench.ms(_flux_call(w, hins)[0])
        del hins
        log(f"faults summary {name}: modeled (H100 model) healthy "
            f"{healthy_ms:.6f} ms, degraded {degraded_ms:.6f} ms; FLUX "
            f"kernel measured {k4:.3f} ms at n={w.n_dev}, "
            f"{records[-1]['ms']:.3f} ms at n={dw.n_dev}")
        if name in apart:
            # the same degraded call with one flag per source (no 2-row
            # chunks): what the chunks cost at n = 3
            kern, knobs = apart[name]
            whole = bench.ms(lambda: kern(*ins, **knobs))
            log(f"faults apart {name} n={dw.n_dev}: {knobs} {whole:.3f} ms "
                f"against FLUX's {records[-1]['ms']:.3f} ms")

    # the straggler observation: the ring's test build, rank 2 slowed
    if not cuda:
        log("faults straggler observation: skipped on the cpu (the slowed "
            "ring is a kernel build)")
        return counts, records
    q, k, v = ring_inputs(ring, device, seed=4)
    plan = FaultPlan(f"slowed-rank-2-{STALL_US}us", (FaultSpec(
        STRAGGLER, rank=2, rounds=ring.n_dev, delay_s=STALL_US * 1e-6),))
    kn = ra.VARIANTS["fused_counter"]
    with torch.no_grad():
        _close("slowed ring", ra.slowed_ring_attention(
            q, k, v, rank=2, us=STALL_US, **kn),
            ra.ring_attention_plain(q, k, v, **kn), 1e-4)
    for contexts in WINDOW_CONTEXTS:
        d = dataclasses.replace(flux, contexts=contexts)
        plain_ms = bench.ms(lambda: ra.ring_attention(
            q, k, v, contexts=contexts, **kn))
        slow_ms = bench.ms(lambda: ra.slowed_ring_attention(
            q, k, v, rank=2, us=STALL_US, contexts=contexts, **kn))
        model = fault_cost(ring, d, hw, plan) - ring.analytic_cost(d, hw)
        log(f"faults straggler observation contexts={contexts}: rank 2 idles "
            f"{STALL_US} us before each of {ring.n_dev} steps; ring "
            f"{plain_ms:.3f} ms, slowed {slow_ms:.3f} ms, measured stall "
            f"{slow_ms - plain_ms:.3f} ms; fault_cost's modeled stall for "
            f"{plan.name} {model * 1e3:.3f} ms (H100 model)")
    del q, k, v
    return counts, records


def phase_serve_degrade(device="cuda", cfg=None, shape=None):
    """Elastic serving on the MoE engine of ``serve_moe`` (the same config,
    weights from seed 0, prompts from seed 5) on ``VirtualMesh(4,
    axis="data")``: 4 requests of ``prompt`` tokens, ``new`` new tokens,
    ``moe_backend="pallas"``, one request a rank, through
    ``serve(on_step=...)`` with an ``ElasticController(4)`` and a
    ``StragglerWatchdog``. At step 1 (after the first decode step) the
    controller drops rank 3 and the engine degrades to the even width 2:
    under pallas that must raise (4 experts on 2 ranks: the kernel takes
    one expert a rank), so the hook switches the engine's options to
    ``moe_backend="xla"`` in the open and degrades. All 4 requests must
    complete with ``serve.degrades`` 1, the tokens counted right and the
    controller's live ranks (0, 1, 2). Prints prefill ms (before the
    degrade in the run; after it, one prefill of the same prompts on the
    degraded engine) and decode ms a step before and after. Then, at
    capacity 4 (no token can drop, as ``serve_moe``'s decode check), the
    same elastic run against an undegraded pallas engine's ``serve``: the
    streams must be equal up to their first split, and there the
    undegraded pick may lead the degraded one by at most one bf16 step in
    the undegraded engine's logits (a tie that f32 sums in another order
    tip). Returns the counters of the elastic run."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.dist.sharding import Rules
    from repro_torch.models import StepOptions, init_params
    from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
    from repro_torch.train import ElasticController, StragglerWatchdog
    cfg = cfg or moe_engine_config()
    _, prompt, new = shape or moe_serve_shape()
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    g = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (4, prompt), generator=g,
                           device=device)
    pallas = StepOptions(moe_backend="pallas", moe_overlap=True)

    def engine(c, watchdog=None):
        return Engine(c, params, ServeConfig(max_seq=prompt + new + 1,
                                             opts=pallas),
                      rules=Rules(VirtualMesh(4, device=device, axis="data"),
                                  "decode"), watchdog=watchdog)

    def run(eng, ctl=None):
        sched = Scheduler(token_budget=4 * prompt, max_batch=4,
                          metrics=eng.metrics)
        for rid in range(4):
            sched.submit(Request(rid, tokens[rid].tolist(),
                                 max_new_tokens=new))
        marks = {"t": [time.perf_counter()]}

        def on_step(step_no, e):
            sync()
            marks["t"].append(time.perf_counter())
            if ctl is None or step_no != 1:
                return
            ctl.drop(3)
            live = len(ctl.live_ranks) // 2 * 2     # even data width
            try:
                e.degrade(live)
            except ValueError as err:
                marks["refused"] = str(err)
            else:
                raise SystemExit("serve_degrade: the pallas engine degraded "
                                 f"onto {live} ranks; the kernel cannot "
                                 "take that width")
            e.scfg.opts = dataclasses.replace(e.scfg.opts, moe_backend="xla")
            e.degrade(live)
            marks["steps"] = len(marks["t"]) - 1
            marks["t"].append(time.perf_counter())   # the degrade's time out

        done = eng.serve(sched, on_step=on_step)
        return done, marks

    # the elastic run at the config's capacity
    ctl = ElasticController(4)
    eng = engine(cfg, StragglerWatchdog())
    engine(cfg).generate({"tokens": tokens[:4, :8]}, 2)   # warm-up
    t0 = time.perf_counter()
    done, marks = run(eng, ctl)
    run_s = time.perf_counter() - t0
    snap = eng.metrics.snapshot()
    c = snap["counters"]
    t = marks["t"]
    k = marks["steps"]
    pre_ms = (t[1] - t[0]) * 1e3
    dec_before = [(t[i + 1] - t[i]) * 1e3 for i in range(1, k)]
    dec_after = [(t[i + 1] - t[i]) * 1e3 for i in range(k + 1, len(t) - 1)]
    sync()
    t1 = time.perf_counter()
    eng.prefill({"tokens": tokens})
    sync()
    pre_after = (time.perf_counter() - t1) * 1e3
    log(f"serve_degrade {cfg.name}: pallas degrade onto 2 ranks refused: "
        f"{marks.get('refused', '')!r}")
    log(f"serve_degrade: 4 requests of {prompt} tokens, {new} new, rank 3 "
        f"dropped at step 1 (live {ctl.live_ranks}, degraded to 2 ranks, "
        f"xla) in {run_s:.3f} s; prefill {pre_ms:.3f} ms at n=4 (pallas), "
        f"{pre_after:.3f} ms after the degrade (n=2, xla); decode "
        f"{sum(dec_before) / max(1, len(dec_before)):.3f} ms a step before "
        f"({len(dec_before)} step), "
        f"{sum(dec_after) / max(1, len(dec_after)):.3f} ms after "
        f"({len(dec_after)} steps); counters degrades "
        f"{c.get('serve.degrades')}, tokens {c.get('serve.tokens_generated')}"
        f", watchdog incidents {c.get('serve.watchdog_incidents', 0)}; "
        f"controller {ctl.metrics.snapshot()['counters']}")
    if "refused" not in marks or "num_experts_padded" not in marks["refused"]:
        raise SystemExit("serve_degrade: the pallas degrade did not name "
                         "num_experts_padded")
    want_tokens = 4 * (new - 1)
    if (sorted(done) != [0, 1, 2, 3]
            or any(len(done[r]) != new for r in done)
            or c.get("serve.degrades") != 1
            or c.get("serve.tokens_generated") != want_tokens
            or ctl.live_ranks != (0, 1, 2)):
        raise SystemExit(f"serve_degrade: done {sorted(done)}, counters {c}, "
                         f"live {ctl.live_ranks}")
    del eng

    # the streams at a capacity where no token drops
    nodrop = dataclasses.replace(cfg, capacity_factor=4.0)
    deg, _ = run(engine(nodrop), ElasticController(4))
    ref_eng = engine(nodrop)
    ref, _ = run(ref_eng)
    got = torch.stack([deg[r] for r in range(4)])
    want = torch.stack([ref[r] for r in range(4)])
    split = (got != want).nonzero()
    log(f"serve_degrade at capacity 4: the degraded stream equals the "
        f"undegraded engine's: {not len(split)}"
        + (f" (first apart at (request, token) {split[0].tolist()})"
           if len(split) else ""))
    if len(split):
        first = int(split[:, 1].min())
        V = cfg.vocab_size
        b = {"tokens": tokens}
        with torch.no_grad():               # the undegraded engine's logits
            lg, cache = ref_eng._prefill(b)
            wt = want.to(device)
            for i in range(first):
                lg, cache = ref_eng._decode(cache, wt[:, i:i + 1].long(),
                                            prompt + i)
        lg = lg[:, -1, :V].float()
        for r in (got[:, first] != want[:, first]).nonzero()[:, 0].tolist():
            pick, other = lg[r, int(want[r, first])], lg[r, int(got[r, first])]
            step = _bf16_step(max(abs(float(pick)), abs(float(other))))
            log(f"serve_degrade first split (request {r}, token {first}): "
                f"the undegraded pick leads the degraded one by "
                f"{float(pick - other):.4f}, one bf16 step at that logit "
                f"size is {step:.4f}")
            if float(pick - other) > step:
                raise SystemExit(f"serve_degrade: the streams split at "
                                 f"(request {r}, token {first}) by more "
                                 "than one bf16 step")
    return c

# ------------------------------------------------- the other model kinds

KIND_SHAPES = {"xlstm-350m": (4, 512, 32),
               "recurrentgemma-9b": (2, 2304, 16),
               "whisper-large-v3": (4, 64, 32)}


def kind_configs(small=False):
    """``(config, (batch, prompt tokens, new tokens))`` of each model kind
    ``serve_kinds`` serves, at every published width and depth, no cut:
    xlstm-350m (24 alternating mLSTM / sLSTM blocks, d 1024), 4 prompts
    of 512 tokens (4 mLSTM chunks of 128); recurrentgemma-9b (38 layers,
    RG-LRU and 2048-token local attention, d 4096, 7.5 B parameters), 2
    prompts of 2304 tokens, so that the window cuts; whisper-large-v3 (32
    encoder layers over 1500 frames, 32 decoder layers, d 1280), 4 prompts
    of 64 tokens. ``small``: the reduced test sizes, with prompts past the
    reduced mLSTM chunk (8) and window (16)."""
    from repro_torch.configs import get_arch, reduced
    return [(reduced(get_arch(n)), (2, 21, 4)) if small
            else (get_arch(n), shape) for n, shape in KIND_SHAPES.items()]


def _kind_batch(cfg, batch, prompt, device, seed=7):
    """Prompt ids (and whisper's frames, in the model's type) from
    ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                 generator=g, device=device)}
    if cfg.is_encoder_decoder:
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        b["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                  generator=g, device=device).to(dtype)
    return b


def phase_serve_kinds(device="cuda", kinds=None):
    """The recurrent kinds and the encoder-decoder through the serving
    engine, counted (the kv counter at 0 before the first kind, read after
    the last): weights from seed 0 on the card, bf16, each config and
    shape of :func:`kind_configs`. For each: ``generate`` after a warm-up
    on an engine of its own, printing prefill ms, decode ms a step and
    tokens/s; the engine replays its own greedy tokens (its prefill and
    decode steps forced on them); the first decode step's logits within
    5e-2 (max-abs-normalised, the real vocab) of ``forward`` over prompt +
    1 tokens. Whisper also hands its cache over through the shuttle on a
    2-rank ``VirtualMesh`` (``[k; v]`` and ``[ck; cv]``, the latter 32 x B
    x 1500 x 20 rows of 64): the handoff equals the direct one bit for
    bit and ``decode_from_handoff`` gives ``generate``'s tokens. The
    recurrent kinds' shuttled handoff must raise (their recurrent blocks
    hold no K/V), as the reference's does.

    Beside each decode reading the phase prints the model's own bf16
    floor: ``forward`` over the same tokens, each row alone against the
    batch (the same function; only the GEMMs' shapes, and so their bf16
    roundings, differ). xLSTM's floor is above 5e-2 (0.123 at 4 x 513
    tokens: its exponential gates carry each rounding through 512
    recurrent steps and 24 layers), so no bf16 computation of it can be
    held to ``forward`` at 5e-2: its decode step is held in float32
    instead, on the same weights from seed 0, within 1e-3 (sums in another
    order), the bf16 reading printed. Returns the kv_shuttle counter."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.kernels import kv_shuttle as kern
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    kern.reset_launches()
    t_phase = time.perf_counter()
    for cfg, (batch, prompt, new) in kinds or kind_configs():
        # each kind's tensors go before the next kind's weights come
        t0 = time.perf_counter()
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
        b = _kind_batch(cfg, batch, prompt, device)
        sync()
        kinds_txt = "/".join(sorted(set(cfg.block_pattern)))
        log(f"serve_kinds {cfg.name}: {cfg.num_layers} layers ({kinds_txt}"
            + (f", {cfg.enc_layers} encoder layers over {cfg.enc_seq} frames"
               if cfg.is_encoder_decoder else "")
            + f") d={cfg.d_model} vocab {cfg.vocab_size} {cfg.dtype}; "
            f"{cfg.param_count() / 1e9:.2f} B parameters from seed 0 in "
            f"{time.perf_counter() - t0:.1f} s")
        scfg = ServeConfig(max_seq=prompt + new + 1)
        Engine(cfg, params, scfg).generate(b, 2)              # warm-up
        eng = Engine(cfg, params, scfg)
        t0 = time.perf_counter()
        toks = eng.generate(b, new)
        sync()
        gen_s = time.perf_counter() - t0
        snap = eng.metrics.snapshot()["histograms"]
        pre_ms = snap["serve.prefill_ms"]["mean"]
        dec_ms = snap["serve.decode_step_ms"]["mean"]
        log(f"serve_kinds {cfg.name} generate: {batch} x {prompt} prompt "
            f"tokens -> {new} new in {gen_s:.3f} s; prefill {pre_ms:.3f} ms "
            f"({batch * prompt / pre_ms * 1e3:.0f} prompt tok/s), decode "
            f"{dec_ms:.3f} ms/step ({batch / dec_ms * 1e3:.0f} tok/s)")
        V = cfg.vocab_size
        with torch.no_grad():
            lg, cache = eng._prefill(b)
            replays = torch.equal(lg[:, -1].argmax(-1).to(toks.dtype),
                                  toks[:, 0])
            for i in range(new - 1):
                lg, cache = eng._decode(cache, toks[:, i:i + 1], prompt + i)
                replays &= torch.equal(lg[:, -1].argmax(-1).to(toks.dtype),
                                       toks[:, i + 1])
                if i == 0:
                    dl = lg[..., :V]
            del cache
        if not replays:
            raise SystemExit(f"serve_kinds {cfg.name}: the engine does not "
                             "replay its own greedy tokens")
        grown = dict(b, tokens=torch.cat([b["tokens"], toks[:, :1].long()],
                                         1))
        fl, floor = _last_logits(params, grown, cfg, alone=True)
        rel = float((dl - fl).abs().max() / (fl.abs().max() + 1e-9))
        held = "mlstm" not in cfg.block_pattern     # xLSTM: in f32 below
        if held:
            _close(f"{cfg.name} decode logits vs forward", dl, fl, LOGIT_TOL)
        log(f"serve_kinds {cfg.name} decode step vs forward over "
            f"{prompt + 1} tokens: logits {tuple(dl.shape)} (the real "
            f"vocab), " + (_reading(rel, LOGIT_TOL) if held else
                           f"rel err {rel:.3e} (bf16, not held)")
            + f"; the bf16 floor (forward, each row alone against the "
            f"batch) {floor:.3e}; the engine replays its {new} greedy "
            "tokens")
        if not held:
            _f32_decode_check(cfg, b, toks[:, :1], prompt, device)
        if cfg.is_encoder_decoder:
            direct = eng.prefill_remote(b)
            t0 = time.perf_counter()
            h = eng.prefill_remote(b, shuttle_mesh=VirtualMesh(2,
                                                               device=device))
            sync()
            hand_s = time.perf_counter() - t0
            same = all(torch.equal(h["cache"][blk][leaf],
                                   direct["cache"][blk][leaf])
                       for blk in direct["cache"]
                       for leaf in direct["cache"][blk])
            equal = torch.equal(eng.decode_from_handoff(h, new), toks)
            rows = {a: h["cache"]["s0"][a].numel() // cfg.hd
                    for a in ("k", "ck")}
            log(f"serve_kinds {cfg.name} handoff: prefill + shuttle "
                f"{hand_s:.3f} s, [k; v] {rows['k']} rows and [ck; cv] "
                f"{rows['ck']} rows x {cfg.hd} per half; cache bit-equal to "
                f"the direct handoff: {same}; decode tokens equal "
                f"generate's: {equal}")
            if not (same and equal):
                raise SystemExit(f"serve_kinds {cfg.name}: the shuttled "
                                 "handoff differs from the direct one")
            del direct, h
        else:                       # recurrent state: no K/V to shuttle
            try:
                eng.prefill_remote(b, shuttle_mesh=VirtualMesh(2,
                                                               device=device))
            except NotImplementedError as err:
                log(f"serve_kinds {cfg.name} shuttled handoff refused: "
                    f"{err}")
            else:
                raise SystemExit(f"serve_kinds {cfg.name}: the shuttle took "
                                 "a cache with recurrent state")
        del params, eng, toks, lg, dl, fl, grown
        if cuda:
            torch.cuda.empty_cache()
    log(f"serve_kinds: all kinds in {time.perf_counter() - t_phase:.1f} s")
    _contexts_seen("serve_kinds", [kern], {2})
    return dict(kern.LAUNCHES)


def _last_logits(params, batch, cfg, alone=False):
    """The last position's logits of ``forward`` over ``batch`` (the real
    vocab); with ``alone``, also the max-abs-normalised gap to the same
    forward run a row at a time."""
    from repro_torch.models import forward
    from repro_torch.models.model import lm_logits
    V = cfg.vocab_size
    with torch.no_grad():
        fl = lm_logits(params, forward(params, batch, cfg)[0][:, -1:],
                       cfg)[..., :V]
        if not alone:
            return fl
        one = torch.cat([lm_logits(params, forward(
            params, {k: v[i:i + 1] for k, v in batch.items()}, cfg)[0][
                :, -1:], cfg)[..., :V] for i in range(fl.shape[0])])
    return fl, float((one - fl).abs().max() / (fl.abs().max() + 1e-9))


def _f32_decode_check(cfg, b, first, prompt, device):
    """``cfg``'s first decode step against ``forward`` over prompt + 1
    tokens in float32, on the weights from seed 0 (the bf16 run's before
    rounding), within 1e-3."""
    from repro_torch.models import decode_step, init_params, prefill_step
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(torch.Generator(device=device).manual_seed(0), f32,
                         device=device)
    with torch.no_grad():
        _, cache = prefill_step(params, b, f32, seq_len=prompt + 2)
        dl, _ = decode_step(params, cache, first.long(), prompt, f32)
    del cache
    grown = dict(b, tokens=torch.cat([b["tokens"], first.long()], 1))
    fl = _last_logits(params, grown, f32)
    rel, _ = _close(f"{cfg.name} f32 decode logits vs forward",
                    dl[..., :cfg.vocab_size], fl, F32_LOGIT_TOL)
    log(f"serve_kinds {cfg.name} in float32 (the same weights): decode step "
        f"vs forward over {prompt + 1} tokens, {_reading(rel, F32_LOGIT_TOL)}")


def handoff_record(bench, label, rows, width, dtype, path):
    """kv_shuttle's pure handoff of one stacked ``[K; V]`` cache block,
    ``rows`` rows of ``width`` a half (the knobs ``prefill_remote``
    passes: chained, contexts 2), held bit for bit against the plain
    version and timed beside one ``Tensor.copy_``; the launches come from
    ``path``."""
    from repro_torch.kernels.kv_shuttle import (kv_cache_shuttle,
                                                kv_shuttle_plain,
                                                variant_name)
    g = torch.Generator(device=bench.device).manual_seed(2)
    kv = torch.zeros((2, 2 * rows, width), dtype=dtype, device=bench.device)
    kv[0] = torch.randn((2 * rows, width), generator=g, device=bench.device)
    sink = torch.empty_like(kv[0])
    key = variant_name(pure=True, rows=rows)
    rec = bench.record(
        f"kv_shuttle/{key}@{label}",
        f"rows={rows} width={width} {str(dtype)[6:]}",
        lambda: kv_cache_shuttle(kv),
        lambda: kv_shuttle_plain(kv, pure=True), "exact",
        kv_bound(pure=True, rows=rows, width=width, esize=kv.element_size()),
        ("copy_", bench.ms(lambda: sink.copy_(kv[0]))), KV_SOURCE,
        KV_REPLACES, (key, rows, width, str(dtype)[6:]), path)
    del kv, sink
    return rec


def whisper_cross_record(bench, cfg=None, shape=None):
    """:func:`handoff_record` of whisper's cross cache ``[ck; cv]`` at the
    engine's shape (32 x B x 1500 x 20 rows of 64, bf16); the launches
    come from ``serve_kinds``."""
    if cfg is None:
        cfg, shape = kind_configs()[2]
    rows = cfg.num_repeats * shape[0] * cfg.enc_seq * cfg.num_kv_heads
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return handoff_record(bench, "whisper_cross", rows, cfg.hd, dtype,
                          "serve_kinds")


# ------------------------------------------------ mixed traffic under pallas

def mixed_traffic(small=False):
    """``(prompt lengths, max_new_tokens, requests submitted from on_step
    at step 2)`` of ``serve_mixed``: 6 requests, two of them late, of four
    lengths and five allowances, so that no group of the run shards over
    the 4 data ranks. ``small``: the test size."""
    if small:
        return [16, 16, 12, 12, 8, 4], [4, 2, 4, 3, 4, 3], (2, 3)
    return [512, 512, 384, 384, 256, 128], [32, 8, 32, 16, 32, 24], (2, 3)


def padded_decode_record(bench, cfg=None):
    """moe_dispatch at the padded layout of a decode group of 3 rows on 4
    ranks (``models/moe.py::_padded_body``: C = ceil(1.25 * 3 / 4) = 1 from
    all three tokens, each source rank's [C] * 4 dst-major slab, rank 3
    padding; the second stream over one row a rank), the knobs the engine
    launches, held within 1e-4 of the plain version and timed beside the
    same GEMMs' ``torch.matmul`` and the bound. The launches come from
    ``serve_mixed``: every decode group there of 1 to 3 rows has this
    kernel shape."""
    from repro_torch.models.moe import _capacity
    cfg = cfg or moe_engine_config()
    n, d, f, rows = 4, cfg.d_model, cfg.moe_d_ff, 3
    C = _capacity(rows, cfg.experts_per_token, cfg.num_experts,
                  cfg.capacity_factor)
    g = torch.Generator(device=bench.device).manual_seed(33)
    kw = dict(generator=g, device=bench.device, dtype=torch.float32)
    tok = torch.randn((rows, d), **kw)
    x = torch.zeros((n, n * C, d), device=bench.device)
    xs = torch.zeros((n, 1, d), device=bench.device)
    for r in range(rows):                 # token r on rank r, to expert r+1
        x[r, (r + 1) % n * C] = tok[r]
        xs[r, 0] = tok[r]
    w1 = torch.randn((n, d, 2 * f), **kw) / d ** 0.5
    w2 = torch.randn((n, f, d), **kw) / f ** 0.5
    shared = (xs, torch.randn((d, 2 * f), **kw) / d ** 0.5,
              torch.randn((f, d), **kw) / f ** 0.5)
    counts = [C] * n
    rec = moe_record(
        bench, "llama4_padded_decode", x, w1, w2, counts, shared,
        dict(tile_fused=True, pipelined=True), min(64, C),
        moe_bound(n, counts, d, f, f, 1, xs_is_x=False),
        moe_library(bench, x, w1, w2, counts, shared), "serve_mixed")
    del x, xs, w1, w2, shared
    return rec


def phase_serve_kernels(device="cuda", iters=5, moe_cfg=None, whisper=None):
    """The two kernel records of this slice's serving paths:
    :func:`padded_decode_record` and :func:`whisper_cross_record`."""
    bench = Bench(device, iters)
    cfg, shape = whisper or (None, None)
    return [padded_decode_record(bench, moe_cfg),
            whisper_cross_record(bench, cfg, shape)]


def phase_serve_mixed(device="cuda", cfg=None, traffic=None):
    """``serve_moe``'s llama4 engine (``moe_engine_config``, weights from
    seed 0) on ``VirtualMesh(4, axis="data")`` under
    ``StepOptions(moe_backend="pallas", moe_overlap=True)``, counted: the
    traffic of :func:`mixed_traffic` through ``serve`` with
    ``Scheduler(max_batch=8)``, the late requests submitted from
    ``on_step`` at step 2. ``serve`` groups decode steps by position and
    prefills by prompt length, so every group here is one that does not
    shard (1 to 3 rows on 4 ranks: ``_padded_body``). It must hold:

    * every request completes with its own ``max_new_tokens``;
    * the moe counter reads MoE layers x (decode groups + prefill
      groups): no group took a host body;
    * at capacity 4 (no token can drop) the tokens equal an xla engine's
      ``serve`` of the same traffic; where a request's streams split, the
      xla pick leads the pallas token by at most one bf16 step in the xla
      engine's logits, replayed for that request alone (a tie that f32
      sums in another order tip), as ``serve_moe`` holds it.

    At the config's capacity 1.25 the same comparison is printed, not
    held. Prints the serve time, decode ms a group, tokens/s and the
    groups' sizes. Returns the moe launch counter of the counted run."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.dist.sharding import Rules
    from repro_torch.kernels import moe_dispatch as kern
    from repro_torch.models import StepOptions, init_params
    from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
    cfg = cfg or moe_engine_config()
    lens, news, late = traffic or mixed_traffic()
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    g = torch.Generator(device=device).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (len(lens), max(lens)),
                           generator=g, device=device)
    prompts = [tokens[r, :n].tolist() for r, n in enumerate(lens)]
    rules = Rules(VirtualMesh(4, device=device, axis="data"), "decode")
    max_seq = max(lens) + max(news) + 1

    def engine(c, backend):
        return Engine(c, params, ServeConfig(max_seq=max_seq, opts=StepOptions(
            moe_backend=backend, moe_overlap=True)), rules=rules)

    def run(eng):
        groups, prefill, decode = [], eng._prefill, eng._decode

        def counted_prefill(batch):
            groups.append(("prefill", batch["tokens"].shape[0]))
            return prefill(batch)

        def counted_decode(cache, toks, pos):
            groups.append(("decode", toks.shape[0]))
            return decode(cache, toks, pos)

        eng._prefill, eng._decode = counted_prefill, counted_decode
        sched = Scheduler(token_budget=sum(lens), max_batch=8,
                          metrics=eng.metrics)
        for rid, p in enumerate(prompts):
            if rid not in late:
                sched.submit(Request(rid, p, max_new_tokens=news[rid]))

        def on_step(step_no, _):
            if step_no == 2:
                for rid in late:
                    sched.submit(Request(rid, prompts[rid],
                                         max_new_tokens=news[rid]))

        t0 = time.perf_counter()
        done = eng.serve(sched, on_step=on_step)
        sync()
        return done, groups, time.perf_counter() - t0

    eng = engine(cfg, "pallas")
    kern.reset_launches()
    done, groups, serve_s = run(eng)
    counts = dict(kern.LAUNCHES)
    _contexts_seen("serve_mixed", [kern], {2})
    c = eng.metrics.snapshot()
    dec = c["histograms"]["serve.decode_step_ms"]
    sizes = {k: sorted(collections.Counter(b for kk, b in groups if kk == k)
                       .items()) for k in ("prefill", "decode")}
    gen = c["counters"]["serve.tokens_generated"] + len(lens)
    log(f"serve_mixed {cfg.name} (pallas, capacity {cfg.capacity_factor}): "
        f"{len(lens)} requests of {lens} prompt tokens, max_new_tokens "
        f"{news}, {list(late)} submitted at step 2: done "
        f"{sorted(done)} in {serve_s:.3f} s ({gen / serve_s:.1f} tok/s); "
        f"decode {dec['mean']:.3f} ms a group over {dec['count']} groups; "
        f"(batch, groups) prefill {sizes['prefill']}, decode "
        f"{sizes['decode']}; moe launches {counts}")
    want = n_moe * len(groups) if cuda else 0
    if sorted(done) != list(range(len(lens))) or any(
            len(done[r]) != news[r] for r in done):
        raise SystemExit("serve_mixed: a request did not complete with its "
                         "own max_new_tokens")
    if sum(counts.values()) != want:
        raise SystemExit(f"serve_mixed launched moe_dispatch "
                         f"{sum(counts.values())} times, not {n_moe} MoE "
                         f"layers x {len(groups)} groups = {want}")
    if all(b % 4 == 0 for _, b in groups):
        raise SystemExit("serve_mixed: every group sharded; the traffic "
                         "did not reach the padded layout")
    del eng

    def first_apart(got, want):
        """{request: its first token where the two streams differ}."""
        return {r: int((got[r].cpu() != want[r].cpu()).nonzero()[0, 0])
                for r in sorted(got)
                if not torch.equal(got[r].cpu(), want[r].cpu())}

    apart = first_apart(done, run(engine(cfg, "xla"))[0])
    log(f"serve_mixed at capacity {cfg.capacity_factor} (not held): "
        f"{len(done) - len(apart)} of {len(done)} requests' tokens equal the "
        f"xla engine's serve; first apart at (request, token) "
        f"{sorted(apart.items())}")
    nodrop = dataclasses.replace(cfg, capacity_factor=4.0)
    pal, _, _ = run(engine(nodrop, "pallas"))
    xla_eng = engine(nodrop, "xla")
    xla, _, _ = run(xla_eng)
    apart = first_apart(pal, xla)
    log(f"serve_mixed at capacity 4: every request's tokens equal the xla "
        f"engine's serve: {not apart}"
        + (f" (first apart at (request, token) {sorted(apart.items())})"
           if apart else ""))
    V = cfg.vocab_size
    for r, j in sorted(apart.items()):
        with torch.no_grad():               # request r alone on the xla engine
            lg, cache = xla_eng._prefill({"tokens": torch.tensor(
                [prompts[r]], device=device)})
            pt = pal[r].to(device)
            for i in range(j):
                lg, cache = xla_eng._decode(cache, pt[None, i:i + 1].long(),
                                            lens[r] + i)
        lg = lg[0, -1, :V].float()
        pick, ours = lg[int(xla[r][j])], lg[int(pal[r][j])]
        step = _bf16_step(max(abs(float(pick)), abs(float(ours))))
        log(f"serve_mixed first split (request {r}, token {j}): the xla "
            f"pick leads the pallas token by {float(pick - ours):.4f}, one "
            f"bf16 step at that logit size is {step:.4f}")
        if float(pick - ours) > step:
            raise SystemExit(f"serve_mixed: request {r}'s streams split at "
                             f"token {j} by more than one bf16 step")
    return counts


# ------------------------------------------ tensor-parallel MoE serving


def tp_engine_config(small=False):
    """The model ``serve_tp`` serves: granite-moe-3b-a800m at its published
    widths and depth (32 layers, d_model 1536, 24 heads with 8 KV heads,
    40 experts padded to 48, top-8, expert d_ff 512, vocab 49155,
    capacity 1.5, replicated expert parallelism, bf16; 3.3 B parameters
    with the padded experts), nothing cut; ``small``: the reduced test
    size at 2 layers."""
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch("granite-moe-3b-a800m")
    return reduced(cfg, num_layers=2) if small else cfg


def tp_serve_shape(small=False):
    """(batch, prompt tokens, new tokens) of ``serve_tp``'s granite
    engines; llama4's engines take the batch and the prompt with
    ``TP_LLAMA4_NEW`` new tokens."""
    return (8, 16, 2) if small else (8, 512, 32)


TP_LLAMA4_NEW = 16
# every bf16 step of granite's (1, 4) engine against the no-mesh engine,
# max-abs-normalised: the model's own bf16 error on these weights (the
# no-mesh engine in bf16 against itself in float32) at its worst step on
# an H100; the mesh engine reads 5.853e-2 there. The first decode step is
# held at LOGIT_TOL
TP_BF16_TOL = 6.789e-2


def _forced_logits(eng, batch, toks, prompt, routes=None):
    """Every step's logits of engine ``eng`` over the real vocab on the
    token stream ``toks`` (B, new): (B, new, V). ``routes``, a list, gets
    each step's routings (``models.moe.record_routes``), a list a step."""
    from repro_torch.models.moe import record_routes
    V = eng.cfg.vocab_size

    def step(fn, *args):
        if routes is None:
            return fn(*args)
        with record_routes() as r:
            out = fn(*args)
        routes.append(r)
        return out

    with torch.no_grad():
        lg, cache = step(eng._prefill, batch)
        out = [lg[..., :V].float()]
        for i in range(toks.shape[1] - 1):
            lg, cache = step(eng._decode, cache, toks[:, i:i + 1], prompt + i)
            out.append(lg[..., :V].float())
    return torch.cat(out, 1)


def _route_splits(ra, rb, k):
    """Where two engines' routings of one token stream differ
    (``_forced_logits``' ``routes``), rank 0's rows (every token where
    there is one data rank): a list a step of ``(MoE layer, token row,
    margin a, margin b)``, a margin the router's k-th largest logit less
    its (k+1)-th for that token in that engine (how near a tie the
    choice of the k-th expert was)."""
    out = []
    for sa, sb in zip(ra, rb):
        apart = []
        for layer, ((la, ia), (lb, ib)) in enumerate(zip(sa, sb)):
            la, lb, ia, ib = (t.reshape(-1, *t.shape[-2:])[0]
                              for t in (la, lb, ia, ib))
            rows = (ia.sort(-1).values != ib.sort(-1).values).any(
                -1).nonzero()[:, 0]
            if len(rows):
                ma, mb = ((v[:, k - 1] - v[:, k]).tolist() for v in (
                    lg[rows].topk(k + 1, dim=-1).values for lg in (la, lb)))
                apart += zip([layer] * len(rows), rows.tolist(), ma, mb)
        out.append(apart)
    return out


def _step_err(got, want):
    """Per step: max |got - want| over the batch and the vocab, over
    max |want| (max-abs-normalised)."""
    return ((got - want).abs().amax(dim=(0, 2))
            / want.abs().amax(dim=(0, 2)).clamp_min(1e-9))


def _first_split(toks, other, lx):
    """Where two free-running greedy streams ``toks`` and ``other`` first
    part: ``(step, [(row, lead, bf16 step)])``, ``lead`` how far the
    second engine's pick leads the first's token in ``lx`` (the second
    engine's logits on the first's stream) and the gap between bf16
    values at that logit size; ``(None, [])`` where they never part."""
    split = (toks != other).nonzero()
    if not len(split):
        return None, []
    first = int(split[:, 1].min())
    rows = []
    for r in (other[:, first] != toks[:, first]).nonzero()[:, 0].tolist():
        pick, ours = lx[r, first, other[r, first]], lx[r, first,
                                                       toks[r, first]]
        rows.append((r, float(pick - ours),
                     _bf16_step(max(abs(float(pick)), abs(float(ours))))))
    return first, rows


def _hold_streams(label, toks, lp, other, lx, tol=LOGIT_TOL):
    """Two engines' greedy streams: ``toks`` and ``lp`` the first
    engine's free-running tokens and its logits on them, ``other`` the
    second's free-running tokens and ``lx`` its logits on the first's
    stream. Held: the first replays its tokens; the logits agree within
    ``tol`` (max-abs-normalised) at every step; the second replays its
    own tokens up to the first split, and there its pick leads the
    first's token by at most one bf16 step (a tie that a rounding tips).
    Returns the per-step errors."""
    if not torch.equal(lp.argmax(-1).to(toks.dtype), toks):
        raise SystemExit(f"{label}: the engine does not replay its own "
                         "greedy tokens")
    step_err = _step_err(lx, lp)
    if not (float(step_err.max()) <= tol and torch.isfinite(lp).all()
            and torch.isfinite(lx).all()):
        raise SystemExit(f"{label}: logits disagree at step "
                         f"{int(step_err.argmax())}: rel err "
                         f"{float(step_err.max()):.3e} (tol {tol:.0e})")
    first, rows = _first_split(toks, other, lx)
    upto = toks.shape[1] if first is None else first + 1
    if not torch.equal(lx[:, :upto].argmax(-1).to(toks.dtype),
                       other[:, :upto]):
        raise SystemExit(f"{label}: up to the first split the second engine "
                         "does not replay its tokens")
    for r, lead, step in rows:
        log(f"{label} first split (row {r}, step {first}): the pick leads "
            f"by {lead:.4f}, one bf16 step at that logit size is "
            f"{step:.4f}")
        if lead > step:
            raise SystemExit(f"{label}: the greedy streams split at (row {r}"
                             f", step {first}) by more than one bf16 step")
    return step_err


def phase_tp_kernels(device="cuda", iters=5, small=False):
    """The kernel record of ``serve_tp``'s path: :func:`handoff_record` of
    granite's cache at the (1, 4) engine's shape (32 x 8 x 545 x 8 rows of
    64 a half, bf16); the launches come from ``serve_tp``."""
    cfg = tp_engine_config(small)
    batch, prompt, new = tp_serve_shape(small)
    rows = cache_rows(cfg, batch, prompt + new + 1)
    return [handoff_record(Bench(device, iters), "granite_handoff", rows,
                           cfg.hd, torch.bfloat16, "serve_tp")]


def phase_serve_tp(device="cuda", small=False):
    """Tensor-parallel MoE through the engine on two-axis meshes, in bf16
    (``small``: the reduced sizes of the CPU test), counted:

    * granite-moe-3b-a800m (``tp_engine_config``; weights from seed 0) on
      ``make_mesh((1, 4), ("data", "model"))``: the replicated expert body,
      12 experts a rank, the partials summed over the model axis. 8
      prompts of 512 tokens, ``generate`` 32 new (after a warm-up on an
      engine of its own); the engine replays its own tokens, in bf16 and
      in float32 (the same weights). Against the same weights with no mesh
      (``_local_moe``; with one data rank the capacity rule is the same),
      on the mesh engine's token stream, held: in bf16 the first decode
      step's logits within 5e-2 (max-abs-normalised) and every step's
      within ``TP_BF16_TOL``; in float32 every step whose routings agree
      (``models.moe.record_routes``: the two engines take the same top-8
      set for every token of the step in every layer) within 1e-3, and
      the free-running tokens equal up to a first split that is a
      one-bf16-step tie. Printed, not held: in each dtype every step's
      error and, at each step whose routings differ, the tokens of the
      earliest such layer with the router's 8th-against-9th logit margin
      in each engine (an f32 sum in another order tips a near tie, and
      the token then takes another expert); the model's own bf16 error
      (the no-mesh engine against itself in float32); the bf16 tokens'
      first split. ``prefill_remote`` on the mesh engine hands the cache
      through ``kv_shuttle.cu``, bit for bit against the direct handoff,
      and decodes generate's tokens from it.
    * the same on ``make_mesh((4,), ("data",))``: every rank runs every
      expert over its own 2 prompts, so capacity is sized per rank and
      other tokens may drop; its first split from the (1, 4) engine is
      printed, not held.
    * ``serve_moe``'s llama4-maverick engine (``moe_engine_config``) under
      ``moe_backend="xla"`` on ``make_mesh((4, 2), ("data", "model"))``:
      the ff-sharded all-to-all body at batch 8 and the gathered body at
      batch 2, each held against the same engine on the data-only (4,)
      mesh (the same capacity rule) as above, ``TP_LLAMA4_NEW`` new
      tokens; the same mesh under ``moe_backend="pallas"`` must raise
      ``ValueError``.

    Every printed number stands beside the card's name and power limit.
    Returns the kv_shuttle launch counter of the handoff."""
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.dist.sharding import Rules, tree_map
    from repro_torch.kernels import kv_shuttle as kvk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import StepOptions, init_params
    from repro_torch.serve import Engine, ServeConfig
    cfg = tp_engine_config(small)
    batch, prompt, new = tp_serve_shape(small)
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    card = card_label(device)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    g = torch.Generator(device=device).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                           device=device)
    b = {"tokens": tokens}
    sync()
    log(f"serve_tp {cfg.name}: {cfg.num_layers} layers, "
        f"{cfg.num_experts} experts padded to {cfg.num_experts_padded} "
        f"top-{cfg.experts_per_token} ({cfg.ep_mode}, capacity "
        f"{cfg.capacity_factor}) d={cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} expert d_ff {cfg.moe_d_ff} "
        f"vocab {cfg.vocab_size} {cfg.dtype}; {cfg.param_count() / 1e9:.2f} "
        f"B parameters from seed 0 in {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    tp = Rules(make_mesh((1, 4), ("data", "model"), device=device), "decode")
    dp = Rules(make_mesh((4,), ("data",), device=device), "decode")

    def engine(c, p, rules, n_new, backend="xla"):
        return Engine(c, p, ServeConfig(
            max_seq=prompt + n_new + 1,
            opts=StepOptions(moe_backend=backend)), rules=rules)

    def timed_generate(eng, what, n_new, label):
        t0 = time.perf_counter()
        toks = eng.generate(what, n_new)
        sync()
        gen_s = time.perf_counter() - t0
        h = eng.metrics.snapshot()["histograms"]
        pre, dec = h["serve.prefill_ms"]["mean"], h["serve.decode_step_ms"][
            "mean"]
        B = what["tokens"].shape[0]
        log(f"serve_tp generate {label}: {B} x {prompt} prompt tokens -> "
            f"{n_new} new in {gen_s:.3f} s; prefill {pre:.3f} ms "
            f"({B * prompt / pre * 1e3:.0f} prompt tok/s), decode {dec:.3f} "
            f"ms/step ({B / dec * 1e3:.0f} tok/s) [{card}]")
        return toks

    engine(cfg, params, tp, new).generate(b, 2)       # warm-up
    eng = engine(cfg, params, tp, new)
    toks = timed_generate(eng, b, new, "granite (1, 4) data x model")
    local = engine(cfg, params, None, new)
    ltoks = timed_generate(local, b, new, "granite, no mesh")
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   params)
    first = min(1, new - 1)                       # the first decode step
    read = {}
    for dt, c, p, t, other, e in (("bf16", cfg, params, toks, ltoks, eng),
                                  ("float32", c32, p32, None, None, None)):
        if e is None:                             # the same in float32
            e = engine(c, p, tp, new)
            t, other = e.generate(b, new), engine(c, p, None, new).generate(
                b, new)
        ra, rb = [], []                           # each step's routings
        lp = _forced_logits(e, b, t, prompt, ra)
        if not torch.equal(lp.argmax(-1).to(t.dtype), t):
            raise SystemExit(f"serve_tp: the {dt} (1, 4) engine does not "
                             "replay its own greedy tokens")
        lx = _forced_logits(engine(c, p, None, new), b, t, prompt, rb)
        err = _step_err(lx, lp).tolist()
        apart = _route_splits(ra, rb, cfg.experts_per_token)
        del ra, rb
        at, rows = _first_split(t, other, lx)
        read[dt] = (err, lx, rows, apart)
        log(f"serve_tp granite {dt} (1, 4) vs no mesh on the (1, 4) token "
            f"stream: first decode step rel err {err[first]:.3e}, every step "
            f"within {max(err):.3e} (worst step {err.index(max(err))}); "
            f"free-running tokens equal: {at is None}"
            + ("" if at is None else f"; first apart at step {at}: "
               + ", ".join(f"row {r} the no-mesh pick leads by {lead:.4f} "
                           f"(one bf16 step {step:.4f})"
                           for r, lead, step in rows)))
        log(f"serve_tp granite {dt}, step by step: rel err "
            + " ".join(f"{v:.3e}" for v in err) + "; (MoE layer, token) "
            f"routings apart {[len(a) for a in apart]}")
        for i, a in enumerate(apart):
            if a:                                 # the earliest layer's
                log(f"serve_tp granite {dt} routings apart at step {i} "
                    f"(rel err {err[i]:.3e}), first at MoE layer {a[0][0]}: "
                    + ", ".join(f"token row {row}, the router's "
                                f"{cfg.experts_per_token}th-against-"
                                f"{cfg.experts_per_token + 1}th logit margin"
                                f" {ma:.3e} on (1, 4), {mb:.3e} with no mesh"
                                for layer, row, ma, mb in a[:4]
                                if layer == a[0][0]))
    # the model's own bf16 error: the no-mesh engine in bf16 against it in
    # float32, on the bf16 (1, 4) engine's token stream
    floor = _step_err(read["bf16"][1], _forced_logits(
        engine(c32, p32, None, new), b, toks, prompt))
    log(f"serve_tp granite bf16 floor (the no-mesh engine against itself in "
        f"float32; not held): {float(floor[first]):.3e} at the first decode "
        f"step, {float(floor.max()):.3e} at worst")
    err = read["bf16"][0]
    if not (err[first] <= LOGIT_TOL and max(err) <= TP_BF16_TOL):
        raise SystemExit(f"serve_tp: the (1, 4) engine's bf16 logits are "
                         f"{err[first]:.3e} from the no-mesh engine's at the "
                         f"first decode step (tol {LOGIT_TOL:.0e}), "
                         f"{max(err):.3e} at worst (tol {TP_BF16_TOL:.3e})")
    err32, _, rows32, apart = read["float32"]
    same = [i for i, a in enumerate(apart) if not a]
    log(f"serve_tp granite float32: the {len(same)} steps whose routings "
        f"agree within {max((err32[i] for i in same), default=0.0):.3e} "
        f"(tol {F32_LOGIT_TOL:.0e})")
    if not all(err32[i] <= F32_LOGIT_TOL for i in same):
        raise SystemExit(f"serve_tp: in float32 the (1, 4) engine's logits "
                         f"part from the no-mesh engine's at a step whose "
                         f"routings agree: steps {same}, rel err "
                         f"{[err32[i] for i in same]} (tol "
                         f"{F32_LOGIT_TOL:.0e})")
    if any(lead > step for _, lead, step in rows32):
        raise SystemExit("serve_tp: in float32 the (1, 4) and no-mesh greedy "
                         "streams split by more than one bf16 step")
    del local, p32, read
    dtoks = timed_generate(engine(cfg, params, dp, new), b, new,
                           "granite (4,) data")
    split = (dtoks != toks).nonzero()
    log(f"serve_tp granite (4,) vs (1, 4) (capacity sized per data rank; "
        f"not held): tokens equal: {not len(split)}"
        + (f" (first apart at (row, step) {split[0].tolist()})"
           if len(split) else ""))
    kvk.reset_launches()
    direct = eng.prefill_remote(b)
    t0 = time.perf_counter()
    h = eng.prefill_remote(b, shuttle_mesh=VirtualMesh(2, device=device))
    sync()
    hand_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(kvk.LAUNCHES)
    same = all(torch.equal(h["cache"][blk][leaf], direct["cache"][blk][leaf])
               for blk in direct["cache"] for leaf in direct["cache"][blk])
    out = eng.decode_from_handoff(h, new)
    equal = torch.equal(out, toks)
    rows = h["cache"]["s0"]["k"].numel() // cfg.hd
    log(f"serve_tp granite (1, 4) handoff through kv_shuttle: prefill + "
        f"shuttle {hand_ms:.3f} ms, {rows} rows x {cfg.hd} a half; cache "
        f"bit-equal to the direct handoff: {same}; decode tokens equal "
        f"generate's: {equal}; kv launches {counts} [{card}]")
    if not (same and equal):
        raise SystemExit("serve_tp: the shuttled handoff differs from the "
                         "direct one")
    if cuda and not sum(counts.values()):
        raise SystemExit("serve_tp: the handoff did not launch kv_shuttle")
    del eng, h, direct, params

    lcfg = moe_engine_config(small)
    lparams = init_params(torch.Generator(device=device).manual_seed(0),
                          lcfg, device=device)
    ltok = torch.randint(0, lcfg.vocab_size, (batch, prompt), generator=g,
                         device=device)
    mesh8 = Rules(make_mesh((4, 2), ("data", "model"), device=device),
                  "decode")
    n_new = min(new, TP_LLAMA4_NEW)
    for B, body in ((batch, "all-to-all"), (2, "gathered")):
        lb = {"tokens": ltok[:B]}
        e8 = engine(lcfg, lparams, mesh8, n_new)
        e4 = engine(lcfg, lparams, dp, n_new)
        t8 = timed_generate(e8, lb, n_new,
                            f"llama4 (4, 2) data x model, {body} body")
        t4 = timed_generate(e4, lb, n_new, f"llama4 (4,) data, {body} body")
        err = _hold_streams(f"serve_tp llama4 {body} (4, 2) vs (4,)", t8,
                            _forced_logits(e8, lb, t8, prompt), t4,
                            _forced_logits(e4, lb, t8, prompt))
        split = (t8 != t4).nonzero()
        log(f"serve_tp llama4 {body} body, batch {B}: (4, 2) vs (4,) logits "
            f"within {float(err.max()):.3e} at every step (tol "
            f"{LOGIT_TOL:.0e}); free-running tokens equal: {not len(split)}"
            + (f" (first apart at (row, step) {split[0].tolist()})"
               if len(split) else ""))
    try:
        engine(lcfg, lparams, mesh8, 2, "pallas").generate(
            {"tokens": ltok}, 2)
    except ValueError as e:
        log(f"serve_tp llama4 (4, 2) under moe_backend='pallas' raises "
            f"ValueError: {str(e)[:96]}...")
    else:
        raise SystemExit("serve_tp: moe_backend='pallas' on a model-axis "
                         "mesh did not raise")
    return counts


# ------------------------------------------------------------------ training

TRAIN_LOSS_DROP = 0.5      # (a): the last loss below the first by 0.5 nats
TRAIN_REMAT_TOL = 2 ** -8  # (a): remat off vs on, loss and gnorm, relative
# (b): step 0's loss on (1, 4) against no mesh, relative: the model's own
# bf16 error on that loss (the no-mesh loss in bf16 against float32) in
# chip run 59 on an H100; the mesh read 2.290e-05 there
TRAIN_TP_TOL = 2.339e-4


def train_configs(small=False):
    """The three models phase ``train`` trains: ``dense`` llama3.2-1b at
    its published widths and depth (16 layers, d 2048, vocab 128256, tied
    embeddings, bf16); ``moe`` granite-moe-3b-a800m at its published
    widths, 8 of its 32 layers (at 32 the f32 AdamW state alone is about
    40 GB); ``resume`` the reference's 100M MoE training config
    (``examples/train_moe_100m.py``). ``small``: each at the reduced test
    size."""
    from repro_torch.configs import get_arch, reduced
    llama, granite = get_arch("llama3.2-1b"), get_arch("granite-moe-3b-a800m")
    if small:
        return {"dense": reduced(llama, num_layers=2),
                "moe": reduced(granite, num_layers=2),
                "resume": reduced(granite, num_layers=2)}
    return {"dense": llama,
            "moe": dataclasses.replace(granite, num_layers=8),
            "resume": reduced(granite, num_layers=8, d_model=512,
                              num_heads=8, num_kv_heads=4, head_dim=64,
                              d_ff=1024, moe_d_ff=1024, num_experts=8,
                              experts_per_token=2, vocab_size=32000,
                              pad_to=2, name="granite-moe-100m")}


def train_shapes(small=False):
    """(global batch, sequence, steps) of each part of phase ``train``."""
    seq = {"dense": 512, "moe": 512, "resume": 256}
    steps = {"dense": 6, "moe": 4, "resume": 8}
    batch = {"dense": 8, "moe": 8, "resume": 16}
    return {k: (batch[k], 16 if small else seq[k], steps[k]) for k in seq}


def _tree_numel(tree, keep=lambda path: True, path=()):
    if isinstance(tree, dict):
        return sum(_tree_numel(v, keep, path + (k,)) for k, v in tree.items())
    return tree.numel() if keep(path) else 0


def _report_training(label, cfg, metrics, params, tokens, card, device):
    """Print each step's loss, gradient norm and time, then tokens/s, the
    share of the card's bf16 peak that 6 N tokens a step reaches (N the
    parameters counted in the tensors; a MoE also with its experts
    counted at k of E) and the peak memory. Returns the losses."""
    h = {k: metrics.histogram(f"train.{k}").samples
         for k in ("loss", "gnorm", "step_ms")}
    for i, (loss, gn, ms) in enumerate(zip(h["loss"], h["gnorm"],
                                           h["step_ms"])):
        log(f"train {label} step {i}: loss {loss:.5f} gnorm {gn:.4f} "
            f"step {ms:.3f} ms [{card}]")
    n = _tree_numel(params)
    steady = h["step_ms"][1:] or h["step_ms"]
    ms = statistics.median(steady)
    line = (f"train {label}: {cfg.num_layers} layers d {cfg.d_model} vocab "
            f"{cfg.vocab_size} {cfg.dtype}, N = {n / 1e9:.4f} B parameters "
            f"in the tensors ({cfg.param_count() / 1e9:.4f} B by "
            f"param_count); {tokens} tokens a step, median step after the "
            f"first {ms:.3f} ms (first {h['step_ms'][0]:.3f} ms): "
            f"{tokens / ms * 1e3:.0f} tokens/s, 6 N tokens at "
            f"{6 * n * tokens / (ms * 1e-3) / 1e12:.1f} TFLOP/s = "
            f"{6 * n * tokens / (ms * 1e-3) / BF16_FLOPS:.4f} of "
            f"{BF16_FLOPS / 1e12:.0f} TFLOP/s")
    if cfg.is_moe:
        experts = _tree_numel(params, lambda p: "moe" in p and p[-1] in (
            "wg", "wu", "wd"))
        na = n - experts + experts * cfg.experts_per_token \
            / cfg.num_experts_padded
        line += (f" (N active {na / 1e9:.4f} B: "
                 f"{6 * na * tokens / (ms * 1e-3) / BF16_FLOPS:.4f})")
    if torch.device(device).type == "cuda":
        line += (f"; peak memory "
                 f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    log(line + f" [{card}]")
    losses = h["loss"]
    if not all(math.isfinite(v) for v in losses + h["gnorm"]):
        raise SystemExit(f"train {label}: a loss or gradient norm is not "
                         f"finite: {losses}, {h['gnorm']}")
    return losses


def _take_apart(label, params, opt_state, cfg, rules, tcfg, device, card):
    """One more step after training, timed in its two parts on the host
    clock with the device synchronized: the loss and its gradients, then
    AdamW (in place, on the trained state)."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.optim import adamw_update
    from repro_torch.train import loss_and_grads
    from repro_torch.train.loop import device_batch
    batch = device_batch(SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
        global_batch=tcfg.global_batch)).batch(tcfg.steps), device)
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    _, grads = loss_and_grads(params, batch, cfg, rules, tcfg.opts)
    sync()
    t1 = time.perf_counter()
    adamw_update(params, grads, opt_state, tcfg.opt)
    sync()
    t2 = time.perf_counter()
    log(f"train {label} step taken apart: loss and gradients "
        f"{(t1 - t0) * 1e3:.3f} ms, AdamW {(t2 - t1) * 1e3:.3f} ms [{card}]")


def _peak_reset(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _train_dense(device, cfg, shape, card, drop):
    """(a): llama3.2-1b, no mesh, remat on; step 0's loss and gradient norm
    against one step with remat off from the same state; the last loss
    below the first by more than ``drop``."""
    from repro_torch.core.telemetry import MetricsRegistry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.models import StepOptions
    from repro_torch.train import TrainConfig, build_state, loss_and_grads, \
        train
    from repro_torch.train.loop import device_batch
    B, S, steps = shape
    tcfg = TrainConfig(steps=steps, global_batch=B, seq_len=S, log_every=1,
                       opt=AdamWConfig(warmup_steps=1, total_steps=steps))
    # remat off, one step from the state train() starts from
    _peak_reset(device)
    params = build_state(torch.Generator(device=device).manual_seed(
        tcfg.seed), cfg, None, None, device)[0]
    batch = device_batch(SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch(0),
        device)
    t0 = time.perf_counter()
    loss_off, grads = loss_and_grads(params, batch, cfg, None,
                                     StepOptions(remat=False))
    gn_off = float(global_norm(grads))
    loss_off = float(loss_off)
    off_s = time.perf_counter() - t0
    peak_off = (torch.cuda.max_memory_allocated(device) / 2**30
                if torch.device(device).type == "cuda" else 0.0)
    del params, grads, batch
    _peak_reset(device)
    metrics = MetricsRegistry()
    losses, last, (params, opt_state) = train(cfg, tcfg, verbose=False,
                                              device=device, metrics=metrics)
    losses = _report_training("dense " + cfg.name, cfg, metrics, params,
                              B * S, card, device)
    _take_apart("dense", params, opt_state, cfg, None, tcfg, device, card)
    del params, opt_state
    gn_on = metrics.histogram("train.gnorm").samples[0]
    err = (abs(losses[0] - loss_off) / abs(loss_off),
           abs(gn_on - gn_off) / abs(gn_off))
    log(f"train dense remat off, one step from the same state: loss "
        f"{loss_off:.5f} gnorm {gn_off:.4f} ({off_s:.3f} s with the first "
        f"call's set-up, peak {peak_off:.2f} GiB) against remat on: rel "
        f"{err[0]:.3e} / {err[1]:.3e} (tol {TRAIN_REMAT_TOL:.3e}) [{card}]")
    if max(err) > TRAIN_REMAT_TOL:
        raise SystemExit("train dense: remat off and on disagree")
    if not (last == steps and losses[-1] < losses[0] - drop):
        raise SystemExit(f"train dense: the loss fell from {losses[0]:.4f} "
                         f"to {losses[-1]:.4f} (want a drop of more than "
                         f"{drop})")


def _train_moe(device, cfg, shape, card):
    """(b): granite at published widths on the (1, 4) data x model mesh;
    step 0's loss against the same model's with no mesh (bf16), and the
    model's own bf16 error there (the no-mesh loss in float32)."""
    from repro_torch.core.telemetry import MetricsRegistry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist.sharding import Rules, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import train_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, build_state, train
    from repro_torch.train.loop import device_batch
    B, S, steps = shape
    tcfg = TrainConfig(steps=steps, global_batch=B, seq_len=S, log_every=1,
                       opt=AdamWConfig(warmup_steps=1, total_steps=steps))
    params = build_state(torch.Generator(device=device).manual_seed(
        tcfg.seed), cfg, None, None, device)[0]
    batch = device_batch(SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch(0),
        device)
    with torch.no_grad():
        local = float(train_loss(params, batch, cfg))
        p32 = tree_map(lambda t: t.float(), params)
        del params
        local32 = float(train_loss(p32, batch, dataclasses.replace(
            cfg, dtype="float32")))
    del p32
    mesh = make_mesh((1, 4), ("data", "model"), device=device)
    _peak_reset(device)
    metrics = MetricsRegistry()
    _, last, (params, opt_state) = train(cfg, tcfg, mesh=mesh, verbose=False,
                                         device=device, metrics=metrics)
    losses = _report_training(f"moe {cfg.name} on (1, 4) data x model", cfg,
                              metrics, params, B * S, card, device)
    _take_apart("moe", params, opt_state, cfg, Rules(mesh, "train"), tcfg,
                device, card)
    del params, opt_state
    err, floor = abs(losses[0] - local) / local, abs(local - local32) / local32
    log(f"train moe step 0 loss on (1, 4) {losses[0]:.5f}, no mesh "
        f"{local:.5f} (bf16; float32 {local32:.5f}): rel {err:.3e} (tol "
        f"{TRAIN_TP_TOL:.3e}); the model's own bf16 error on it {floor:.3e} "
        f"[{card}]")
    if err > TRAIN_TP_TOL:
        raise SystemExit("train moe: the (1, 4) mesh's step 0 loss is off "
                         "the no-mesh loss")
    if not (last == steps and losses[-1] < losses[0]):
        raise SystemExit(f"train moe: the loss did not fall: {losses}")


def _train_resume(device, cfg, shape, card, root):
    """(c): the 100M MoE on (4, 2) under ``moe_overlap``: 8 steps in two
    runs of 4 through a checkpoint against two uninterrupted runs, under
    ``torch.use_deterministic_algorithms``; the step-4 checkpoint restored
    with no mesh, bit-equal, and trained on; pallas raising."""
    import shutil
    from repro_torch.core.telemetry import MetricsRegistry
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import StepOptions
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, build_state, loss_and_grads,
                                   restore_checkpoint, train)
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.loop import device_batch
    B, S, steps = shape
    half = steps // 2
    shutil.rmtree(root, ignore_errors=True)
    mesh = make_mesh((4, 2), ("data", "model"), device=device)

    def tcfg(name=None):
        return TrainConfig(steps=steps, global_batch=B, seq_len=S,
                           ckpt_dir=str(root / name) if name else "",
                           ckpt_every=half,
                           log_every=1, opts=StepOptions(moe_overlap=True),
                           opt=AdamWConfig(warmup_steps=1, total_steps=steps))

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = [train(cfg, tcfg(), mesh=mesh, verbose=False,
                      device=device)[0] for _ in range(2)]
        metrics = MetricsRegistry()
        first, _, (params4, opt4) = train(
            cfg, tcfg("c"), mesh=mesh, verbose=False, device=device,
            max_steps_this_run=half, metrics=metrics)
        shutil.copytree(root / "c", root / "d")
        second, last, _ = train(cfg, tcfg("c"), mesh=mesh, verbose=False,
                                device=device, metrics=metrics)
    finally:
        torch.use_deterministic_algorithms(was)
    spread = max(abs(x - y) for x, y in zip(*runs))
    gap = max(abs(x - y) for x, y in zip(first + second, runs[0]))
    save_s = metrics.histogram("train.ckpt_save_s").samples
    log(f"train resume {cfg.name} on (4, 2), {B} x {S}: uninterrupted "
        f"{' '.join(f'{v:.6f}' for v in runs[0])}; two runs apart by "
        f"{spread:.3e}, {half} + {steps - half} steps through the step-"
        f"{half} checkpoint apart from the first by {gap:.3e} (deterministic "
        f"algorithms; held at {4 * spread:.3e}, 4x the spread); saves "
        f"{' '.join(f'{v:.3f}' for v in save_s)} s [{card}]")
    if not (last == steps and len(first) + len(second) == steps
            and gap <= 4 * spread):
        raise SystemExit("train resume: the resumed run's losses differ from "
                         "the uninterrupted run's")
    like = build_state(torch.Generator(device=device).manual_seed(0), cfg,
                       None, None, device)[:2]
    t0 = time.perf_counter()
    got, at = restore_checkpoint(root / "d", {"params": like[0],
                                              "opt": like[1]})
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    restore_s = time.perf_counter() - t0
    want = _flatten({"params": params4, "opt": opt4})
    same = at == half and all(torch.equal(v, want[k]) for k, v in
                              _flatten(got).items())
    log(f"train resume: the step-{at} checkpoint restored with no mesh in "
        f"{restore_s:.3f} s, every leaf bit-equal to the (4, 2) run's state: "
        f"{same} [{card}]")
    if not same:
        raise SystemExit("train resume: the restored state differs")
    del got, like, params4, opt4
    on, _, (params, _) = train(cfg, tcfg("d"), verbose=False, device=device)
    log(f"train resume: steps {half}..{steps - 1} with no mesh from the "
        f"checkpoint: {' '.join(f'{v:.6f}' for v in on)} (the (4, 2) run: "
        f"{' '.join(f'{v:.6f}' for v in runs[0][half:])}) [{card}]")
    if not (len(on) == steps - half and all(math.isfinite(v) for v in on)):
        raise SystemExit("train resume: training on with no mesh failed")
    b = device_batch(SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch(0),
        device)
    try:
        loss_and_grads(params, b, cfg, Rules(mesh, "train"),
                       StepOptions(moe_backend="pallas"))
    except ValueError as e:
        log(f"train resume: train_loss under moe_backend='pallas' raises "
            f"ValueError: {e}")
    else:
        raise SystemExit("train resume: pallas under autograd did not raise")
    shutil.rmtree(root, ignore_errors=True)


def phase_train(device="cuda", small=False, root=None):
    """The trainer on the card (``small``: the reduced sizes of the CPU
    test), with every kernel's launch counter at 0 before and after:

    (a) ``train_dense``: llama3.2-1b at every published width and depth,
        no mesh, 8 x 512, 6 steps of ``train`` (AdamW warm-up 1, remat),
        and one step with remat off from the same state: loss and
        gradient norm within ``TRAIN_REMAT_TOL``; the last loss below the
        first by ``TRAIN_LOSS_DROP`` (by anything at the small size).
    (b) ``train_moe``: granite-moe at its published widths, 8 layers, on
        ``make_mesh((1, 4), ("data", "model"))``, 8 x 512, 4 steps; step
        0's loss within ``TRAIN_TP_TOL`` of the no-mesh loss, and falling.
    (c) ``train_resume``: ``examples/train_moe_100m.py``'s config on
        ``make_mesh((4, 2), ...)`` with ``moe_overlap``, 16 x 256, 8 steps
        in two runs through a checkpoint (``ckpt_every=4``) against an
        uninterrupted run, under deterministic algorithms; the step-4
        checkpoint restored with no mesh bit-equal and trained on; pallas
        raising under autograd. Checkpoints go to ``root``
        (``build/repro_torch/train_ckpt`` of the checkout by default) and
        are removed.

    Each part prints every step's loss, gradient norm and ms, tokens/s,
    the share of the bf16 peak 6 N tokens reaches and the peak memory,
    beside the card's name and power limit. Returns the launch counters
    that moved (none: the trainer launches no hand-written kernel)."""
    import importlib
    mods = [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in KERNELS]
    for m in mods:
        m.reset_launches()
    card = card_label(device)
    cfgs, shapes = train_configs(small), train_shapes(small)
    root = Path(root) if root is not None else \
        ROOT / "build" / "repro_torch" / "train_ckpt"
    t0 = time.perf_counter()
    _train_dense(device, cfgs["dense"], shapes["dense"], card,
                 0.0 if small else TRAIN_LOSS_DROP)
    _train_moe(device, cfgs["moe"], shapes["moe"], card)
    _train_resume(device, cfgs["resume"], shapes["resume"], card, root)
    counts = {name: dict(m.LAUNCHES)
              for name, m in zip(KERNELS, mods)}
    log(f"train: all three parts in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {counts}")
    moved = {k: v for k, v in counts.items() if sum(v.values())}
    if moved:
        raise SystemExit(f"train: the trainer launched kernels: {moved}")
    return moved


# ------------------------------------------------------------------- dry run

DRYRUN_CELLS = (("llama3.2-1b", "train_4k"),
                ("granite-moe-3b-a800m", "train_4k"),
                ("xlstm-350m", "train_4k"))
DRYRUN_PEAK_TOL = 0.10     # op_count's peak against the card's, relative
DRYRUN_SCALED_S = 60       # what an xLSTM cell's trace should take, s


def xlstm_train(small=False):
    """Part (b)'s xLSTM step: xlstm-350m at its published widths, two
    repeat units (an mLSTM and an sLSTM block each), 4 x 512 (4 chunks);
    ``small``: the reduced config, two units, 4 x 32 (4 chunks of 8).
    Returns (cfg, batch, sequence)."""
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch("xlstm-350m")
    if small:
        return reduced(cfg, num_layers=2 * cfg.repeat_unit), 4, 32
    return dataclasses.replace(cfg, num_layers=2 * cfg.repeat_unit), 4, 512


def _meta_twin(args):
    """``args`` (a tuple of trees) with every tensor an uninitialised meta
    tensor of its shape, strides and type; a 0-d host tensor (the
    optimizer's step) copied, other leaves as they are."""
    from repro_torch.dist.sharding import tree_map

    def twin(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dim() == 0 and t.device.type == "cpu":
            return t.clone()
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device="meta")
    return tuple(tree_map(twin, a) for a in args)


def _step_ms(fn, args, device, steps=3):
    """The median of ``steps`` calls of ``fn(*args)`` after one warm-up,
    each on the host clock with the device synchronized."""
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    fn(*args)
    sync()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _dryrun_steps(device, small):
    """(b)'s steps, each ``(label, build, scaled)``: ``build()`` makes the
    step's arguments on ``device`` and returns ``(fn, args, meta_fn)``
    (the same step over a meta mesh where it has one); ``scaled`` is
    ``(cfg, shape)`` where the dry run scales the step's loops
    (``launch.dryrun.scaled_count``, which builds the step as
    ``launch.specs.input_specs`` does: default AdamW), else None."""
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import StepOptions, init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_state
    from repro_torch.train.loop import device_batch
    from repro_torch.configs.base import ShapeConfig
    cfgs, shapes = train_configs(small), train_shapes(small)
    opt = AdamWConfig(warmup_steps=1, total_steps=6)
    B, S, _ = shapes["dense"]
    dense = cfgs["dense"]
    new = serve_shape(small)[2]

    def batch(cfg, B, S):
        return device_batch(SyntheticTokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch(0),
            device)

    def train_dense():
        params, opt_state = build_state(torch.Generator(
            device=device).manual_seed(0), dense, None, None, device)[:2]
        fn = make_train_step(dense, None, StepOptions(), opt)
        return fn, (params, opt_state, batch(dense, B, S)), fn

    def serve(decode):
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             dense, device=device)
        prefill = make_prefill_step(dense, None, StepOptions(), S + new)
        tokens = {"tokens": batch(dense, B, S)["tokens"]}
        if not decode:
            return prefill, (params, tokens), prefill
        logits, cache = prefill(params, tokens)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        step = make_serve_step(dense, None, StepOptions())
        return step, (params, cache, tok, S), step

    def train_moe():
        cfg = cfgs["moe"]
        Bm, Sm, _ = shapes["moe"]
        meshes = [make_mesh((1, 4), ("data", "model"), device=d)
                  for d in (device, "meta")]
        rules = [Rules(m, "train") for m in meshes]
        params, opt_state = build_state(torch.Generator(
            device=device).manual_seed(0), cfg, meshes[0], rules[0],
            device)[:2]
        return (make_train_step(cfg, rules[0], StepOptions(), opt),
                (params, opt_state, batch(cfg, Bm, Sm)),
                make_train_step(cfg, rules[1], StepOptions(), opt))

    xcfg, Bx, Sx = xlstm_train(small)

    def train_xlstm():
        params, opt_state = build_state(torch.Generator(
            device=device).manual_seed(0), xcfg, None, None, device)[:2]
        fn = make_train_step(xcfg, None, StepOptions(), AdamWConfig())
        tokens = {k: v.to(torch.int32)         # the dry run's int32 batch
                  for k, v in batch(xcfg, Bx, Sx).items()}
        return fn, (params, opt_state, tokens), fn

    return [(f"train_dense {dense.name} {B} x {S}", train_dense, None),
            (f"prefill {dense.name} {B} x {S}", lambda: serve(False), None),
            (f"decode {dense.name} {B} x 1 at {S}", lambda: serve(True),
             None),
            (f"train_moe {cfgs['moe'].name} {cfgs['moe'].num_layers} layers "
             f"on (1, 4), {shapes['moe'][0]} x {shapes['moe'][1]}",
             train_moe, None),
            (f"train_xlstm {xcfg.name} {xcfg.num_layers} layers, {Bx} x {Sx}",
             train_xlstm, (xcfg, ShapeConfig("train_xlstm", Sx, Bx,
                                              "train")))]


def _held_to_card(label, fn, args, meta_fn, device, card, scaled=None):
    """One step of (b): its time on ``device``, its count there and on
    meta (equal in FLOPs, bytes and collectives), the H100 model's terms
    against the measured step, and the memory gates; with ``scaled``
    (see ``_dryrun_steps``) also the dry run's scaled count of the step,
    equal to the count on ``device`` in FLOPs and bytes and to the dry
    run's full meta trace in peak. Returns the line's numbers."""
    import gc
    from repro_torch.core.cost_model import roofline_from_count
    from repro_torch.core.hardware import H100
    from repro_torch.core.op_count import op_count, storage_bytes
    cuda = torch.device(device).type == "cuda"
    ms, times = _step_ms(fn, args, device)
    arg_b = storage_bytes(args)
    gc.collect()
    _peak_reset(device)
    if cuda:           # what the process holds besides the step's arguments
        other = torch.cuda.memory_allocated(device) - arg_b
    with op_count(held=args) as here:
        fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
        max_alloc = torch.cuda.max_memory_allocated(device)
        step_peak = max_alloc - other
    meta_args = _meta_twin(args)
    meta_fn(*meta_args)                 # a warm-up, as on the device
    with op_count(held=meta_args) as meta:
        meta_fn(*meta_args)
    del meta_args
    same = (here.flops, here.bytes, [dataclasses.astuple(e) for e in
                                      here.events]) == \
        (meta.flops, meta.bytes, [dataclasses.astuple(e) for e in
                                  meta.events])
    rep = roofline_from_count(here, None, H100)
    step_s = ms / 1e3
    log(f"dryrun {label}: {here.flops:.6e} FLOP, {here.bytes:.6e} bytes, "
        f"{len(here.events)} collectives, {here.ops} ops on {device} (meta: "
        f"{meta.flops:.6e} / {meta.bytes:.6e} / {len(meta.events)}; equal "
        f"{same}); H100 model compute_s {rep.compute_s * 1e3:.3f} ms, "
        f"memory_s {rep.memory_s * 1e3:.3f} ms, step_time_s "
        f"{rep.step_time_s * 1e3:.3f} ms ({rep.dominant}) against the "
        f"measured step {ms:.3f} ms (median of "
        f"{' '.join(f'{t:.3f}' for t in times)} after a warm-up): "
        f"{rep.compute_s / step_s:.4f} / {rep.memory_s / step_s:.4f} / "
        f"{rep.step_time_s / step_s:.4f} of it [{card}]")
    if not same:
        raise SystemExit(f"dryrun {label}: the meta trace and the trace on "
                         f"{device} count different work")
    if scaled is not None:
        _scaled_held(label, scaled, here, card)
    if not cuda:
        log(f"dryrun {label}: arguments {arg_b / 2**30:.3f} GiB, op_count "
            f"peak {here.peak_bytes / 2**30:.3f} GiB; the card's peak not "
            f"measured [{card}]")
        return rep, ms
    log(f"dryrun {label}: arguments {arg_b / 2**30:.3f} GiB, op_count peak "
        f"{here.peak_bytes / 2**30:.3f} GiB, max_memory_allocated "
        f"{max_alloc / 2**30:.3f} GiB less {other / 2**30:.3f} GiB the "
        f"process held besides the arguments: {step_peak / 2**30:.3f} GiB "
        f"(op_count/card {here.peak_bytes / step_peak:.4f}, tol "
        f"{DRYRUN_PEAK_TOL}) [{card}]")
    if rep.compute_s > step_s or rep.step_time_s > step_s:
        raise SystemExit(f"dryrun {label}: the card beat the bound — the "
                         "count is wrong")
    if arg_b > step_peak or abs(here.peak_bytes - step_peak) \
            > DRYRUN_PEAK_TOL * step_peak:
        raise SystemExit(f"dryrun {label}: the count's memory disagrees "
                         "with the card's")
    return rep, ms


def _scaled_held(label, scaled, here, card):
    """``launch.dryrun.scaled_count`` of a step, from short traces on meta,
    against the step's count ``here`` (FLOPs, bytes) and the peak of the
    dry run's full trace of it (``launch.dryrun._trace``: what the run
    makes, arguments not held)."""
    from repro_torch.launch.dryrun import _trace, scaled_count
    from repro_torch.models import StepOptions
    cfg, shape = scaled
    t0 = time.perf_counter()
    got, traces = scaled_count(cfg, shape, None, StepOptions())
    t1 = time.perf_counter()
    full = _trace(cfg, shape, None, StepOptions())
    same = (got.flops, got.bytes, got.peak_bytes) == (here.flops,
                                                      here.bytes,
                                                      full.peak_bytes)
    log(f"dryrun {label}: scaled count ({traces} meta traces, "
        f"{t1 - t0:.1f} s) "
        f"{got.flops:.6e} FLOP, {got.bytes:.6e} bytes, peak "
        f"{got.peak_bytes} bytes against the count on the device "
        f"{here.flops:.6e} / {here.bytes:.6e} and the full meta trace's "
        f"peak {full.peak_bytes} ({time.perf_counter() - t1:.1f} s): equal "
        f"{same} [{card}]")
    if not same:
        raise SystemExit(f"dryrun {label}: the scaled count differs from "
                         "the full trace")


def phase_dryrun(device="cuda", small=False, artifacts=None):
    """The dry run and its count held against the card (``small``: the
    CPU test's form: (a) at ``decode_32k``, (b) at the reduced sizes):

    (a) ``launch/dryrun.py::run_cell`` on three production cells,
        llama3.2-1b, granite-moe-3b-a800m and xlstm-350m at ``train_4k``
        on the 16 x 16 mesh, traced on meta (xLSTM's by
        ``scaled_count``, which should take under ``DRYRUN_SCALED_S``):
        one summary line each; granite's must count its MoE layers'
        collectives (the replicated expert body's all-reduces over the
        model axis). With ``artifacts`` (a directory) each cell is also
        written there as ``launch.dryrun`` writes it, for phase
        ``figures``' ``roofline_cells``.
    (b) five steps, built as the dry run builds them
        (``launch/specs.py``): ``train_dense``'s step (llama3.2-1b, 8 x
        512, no mesh, remat, AdamW), the same model's prefill at 8 x 512
        and one decode step after it, ``train_moe``'s (granite, 8
        layers, on (1, 4), 8 x 512) and ``train_xlstm`` (xlstm-350m at
        its published widths, two repeat units, 4 x 512, remat, AdamW;
        ``xlstm_train``; int32 tokens, as the dry run's), whose scaled
        count must also equal its count on the device (FLOPs, bytes) and
        the dry run's full meta trace of it (peak). Each is
        timed (median of 3 after a warm-up), counted on the device and on
        meta (equal FLOPs, bytes and collectives: the same program), and
        the H100 model's terms of the whole program on one card are
        printed beside the measured step. On the card ``compute_s`` and
        ``step_time_s`` must not exceed the step, and the step's peak
        (``max_memory_allocated`` less what the process held besides the
        step's arguments when it started) must be at least the
        arguments and within ``DRYRUN_PEAK_TOL`` of op_count's peak
        (arguments and every storage the step makes).

    Every number beside the card's name and power limit."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.dryrun import loops_over_tokens, run_cell
    card = card_label(device)
    t0 = time.perf_counter()
    cells = [(a, "decode_32k") for a, _ in DRYRUN_CELLS] if small \
        else DRYRUN_CELLS
    for arch, shape in cells:
        t1 = time.perf_counter()
        d = run_cell(arch, shape, False, verbose=False)
        r, m = d["roofline"], d["memory"]
        kinds = collections.Counter(c.split()[0] for c in
                                    d["collective_schedule"])
        took = time.perf_counter() - t1
        how = " scaled by the loops' trip counts" if loops_over_tokens(
            get_arch(arch), get_shape(shape)) else ""
        log(f"dryrun cell {arch} {shape} {d['mesh']} (meta{how}, "
            f"{took:.1f} s{f', limit {DRYRUN_SCALED_S} s' if how else ''})"
            f": per device {r['flops']:.4e} "
            f"FLOP, {r['bytes']:.4e} bytes, {r['n_collectives']} collectives "
            f"({dict(kinds)} among the 20 largest), H100 model compute "
            f"{r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
            f"collective {r['collective_s']:.4f} s, {r['dominant']}; "
            f"useful FLOPs {d['useful_flops_ratio']:.3f}; arguments "
            f"{m['argument_bytes'] / 2**30:.3f} GiB, peak "
            f"{m['peak_bytes'] / 2**30:.3f} GiB a device")
        if arch.startswith("granite") and not r["n_collectives"]:
            raise SystemExit(f"dryrun {arch}: no MoE collective counted")
        if artifacts is not None:
            Path(artifacts).mkdir(parents=True, exist_ok=True)
            (Path(artifacts) / f"{arch}__{shape}__single.json").write_text(
                json.dumps(d, indent=1, default=str))
    for label, build, scaled in _dryrun_steps(device, small):
        fn, args, meta_fn = build()
        _held_to_card(label, fn, args, meta_fn, device, card, scaled)
        del fn, args, meta_fn
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    log(f"dryrun: {time.perf_counter() - t0:.1f} s [{card}]")


# ------------------------------------------------------------------ examples

def phase_examples(device="cuda", small=False, root=None):
    """The four examples of ``repro_torch.examples`` at their smallest
    arguments and the schedule lint, on ``device`` (``small``: the CPU
    test's shorter runs): ``quickstart`` a few steps, ``serve_decode``,
    ``codesign_search --workload moe_dispatch --generations 1 --islands
    1`` (its cascade launches ``moe_dispatch.cu`` on the card),
    ``train_moe_100m`` a few steps with its checkpoints under ``root``
    (``build/repro_torch/examples`` of the checkout by default, removed),
    ``schedule_lint`` (exit 0). Each example's output goes to
    ``<root>/<name>.log``. Returns the moe launch counter of the run."""
    import contextlib
    import shutil
    from repro_torch.examples import (codesign_search, quickstart,
                                      serve_decode, train_moe_100m)
    from repro_torch.kernels import moe_dispatch as kern
    from repro_torch.tools import schedule_lint
    card = card_label(device)
    root = Path(root) if root is not None else \
        ROOT / "build" / "repro_torch" / "examples"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    dev = ["--device", str(device)]
    runs = [
        ("quickstart", quickstart.main, ["--steps", "3"] + dev),
        ("serve_decode", serve_decode.main,
         (["--batch", "2", "--prompt-len", "8", "--new-tokens", "4"]
          if small else []) + dev),
        ("codesign_search", codesign_search.main,
         ["--workload", "moe_dispatch", "--generations", "1", "--islands",
          "1"] + dev),
        ("train_moe_100m", train_moe_100m.main,
         ["--steps", "1" if small else "3", "--ckpt", str(root / "ckpt")]
         + (["--batch", "4", "--seq", "16"] if small else []) + dev),
        ("schedule_lint", schedule_lint.main, ["--quiet"]),
    ]
    kern.reset_launches()
    t0 = time.perf_counter()
    out = {}
    for name, main, argv in runs:
        t1 = time.perf_counter()
        with open(root / f"{name}.log", "w") as f, \
                contextlib.redirect_stdout(f):
            out[name] = main(argv)
        log(f"examples {name} {' '.join(argv)}: "
            f"{time.perf_counter() - t1:.1f} s (output in "
            f"{root / name}.log) [{card}]")
    counts = dict(kern.LAUNCHES)
    losses, toks = out["quickstart"]
    mono, disagg = out["serve_decode"]
    res = out["codesign_search"]
    moe_losses, last = out["train_moe_100m"]
    log(f"examples: quickstart loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{tuple(toks.shape)} tokens; serve_decode disaggregated equals "
        f"monolithic: {torch.equal(mono, disagg)}; codesign_search best "
        f"score {res.best.score:.3f} (seed {res.seed_score:.3f}), moe "
        f"launches {sum(counts.values())}; train_moe_100m to step {last}, "
        f"loss {moe_losses[0]:.4f} -> {moe_losses[-1]:.4f}; schedule_lint "
        f"exit {out['schedule_lint']}; {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    if not (all(math.isfinite(v) for v in losses + moe_losses)
            and torch.equal(mono, disagg) and out["schedule_lint"] == 0
            and res.best.score >= res.seed_score):
        raise SystemExit("examples: an example failed its check")
    if torch.device(device).type == "cuda" and not sum(counts.values()):
        raise SystemExit("examples: codesign_search launched no "
                         "moe_dispatch kernel")
    shutil.rmtree(root / "ckpt", ignore_errors=True)
    return counts


# ------------------------------------------------------------------ suites

def _suite_kernels():
    from repro_torch.kernels import (gemm_allgather, kv_shuttle,
                                     moe_dispatch, ring_attention)
    return {"moe_dispatch": moe_dispatch, "kv_shuttle": kv_shuttle,
            "gemm_allgather": gemm_allgather,
            "ring_attention": ring_attention}


def suite_record_cases():
    """(kernel module, workload-suite case, directive) of phase ``suites``'
    ``kernels``-line records: one a kernel, at the workload suite's shape —
    the ring's COUNTER TILE_FUSED point (BH 4, seq 512, hd 64), moe's
    pipelined tight dispatch (4 x 256 tokens, d 128, f 256, skew 3), the
    FLUX shuttle at ``kv_chunk`` 32 and gemm_allgather's TILE_FUSED SIGNAL
    at ``tile_m`` 32 (each at its workload's verification inputs)."""
    from repro_torch.suites import workload as suite
    ring, moe, _, _, kv, ga = suite.cases()
    return [("ring_attention", ring, ring[2][4]),
            ("moe_dispatch", moe, moe[2][4]),
            ("kv_shuttle", kv, kv[2][4]),
            ("gemm_allgather", ga, ga[2][2])]


def _suite_plain(w, d, ins):
    """The plain version of the kernel ``w.build(d)`` launches, with the
    knobs the build passes, on ``ins``."""
    if w.name == "gemm_allgather":
        from repro_torch.kernels.gemm_allgather import gemm_allgather_plain
        k = w.kernel_knobs(d, ins[0].shape[1])
        return lambda: gemm_allgather_plain(
            *ins, tile_m=k["tile_m"], fused=k["fused"], counter=k["counter"],
            contexts=k["contexts"])
    k = w.kernel_knobs(d)
    if w.name == "moe_dispatch":
        from repro_torch.kernels.moe_dispatch import moe_dispatch_combine_ref
        counts = [int(c) for c in w._counts(ins[0].shape[1])]
        return lambda: moe_dispatch_combine_ref(
            *ins, counts=counts, block_tokens=k["block_tokens"],
            tight=k["tight"], wire_i8=bool(k["wire_i8"]),
            contexts=k["contexts"])
    if w.name == "kv_transfer":
        from repro_torch.kernels.kv_shuttle import kv_shuttle_plain
        return lambda: kv_shuttle_plain(
            *ins, chained=k["chained"], fused=k["fused"],
            counter=k["counter"], kv_chunk=k["kv_chunk"],
            contexts=k["contexts"])
    from repro_torch.kernels.ring_attention import ring_attention_plain
    return lambda: ring_attention_plain(
        *ins, causal=True, fused=k["fused"], counter=k["counter"],
        kv_chunk=k["kv_chunk"], pipelined=k["pipelined"],
        eager_wait=k["eager"], contexts=k["contexts"])


def _suite_bound_and_library(bench, w, ins):
    """(bound, library) of one call of ``w``'s kernel on ``ins``: the
    bounds of the kernel phases and the same library calls."""
    if w.name == "moe_dispatch":
        x, w1, w2 = ins
        counts = [int(c) for c in w._counts(x.shape[1])]
        bnd = moe_bound(w.n_dev, counts, x.shape[2], w2.shape[1])
        return bnd, moe_library(bench, x, w1, w2, counts, None)
    if w.name == "kv_transfer":
        x, wk, wv = ins
        return (kv_bound(pure=False, rows=x.shape[1], width=wk.shape[1],
                         d=x.shape[2]),
                ("matmul", bench.ms(lambda: (torch.matmul(x[0], wk),
                                             torch.matmul(x[0], wv)))))
    if w.name == "gemm_allgather":
        a, b = ins
        n, M_l, K = a.shape
        sink = torch.empty((n, n * M_l, b.shape[1]), device=a.device)
        return ga_bound(n, M_l, K, b.shape[1]), ("matmul+copy", bench.ms(
            lambda: sink.copy_(torch.matmul(a.reshape(-1, K), b)[None]
                               .expand_as(sink))))
    n, BH, Sl, hd = ins[0].shape
    whole = [gathered(t).contiguous() for t in ins]
    return attn_bound(BH, n * Sl, hd, True), (
        "sdpa", bench.ms(lambda: _sdpa(*whole, True)))


SOURCES = {"moe_dispatch": (SOURCE, REPLACES),
           "kv_shuttle": (KV_SOURCE, KV_REPLACES),
           "gemm_allgather": (GA_SOURCE, GA_REPLACES),
           "ring_attention": (RING_SOURCE, RING_REPLACES)}


def build_record(bench, name, label, w, d, mesh, ins, path, tol=1e-4):
    """The ``kernels``-line record of kernel ``name`` as ``w.build(d)``
    launches it on ``ins``: launched once (the launch it adds to its
    wrapper's count names the record's key on ``path``), held to its
    plain version within ``tol`` and timed beside its bound and library
    call (:func:`_suite_bound_and_library`)."""
    kern = _suite_kernels()[name]
    run = lambda: w.build(d, mesh)(*ins)  # noqa: E731
    before = collections.Counter(kern.LAUNCHES)
    with torch.no_grad():
        got = run()
    new = [k for k, v in kern.LAUNCHES.items() if v != before.get(k, 0)]
    key = new[0] if new else (d.placement, "plain")
    shape = f"{w.name} " + ", ".join("x".join(map(str, t.shape))
                                     for t in ins)
    bnd, lib = _suite_bound_and_library(bench, w, ins)
    return bench.record(
        f"{name}/{key[0]}@{label}", f"{shape} f32", run,
        _suite_plain(w, d, ins), tol, bnd, lib, *SOURCES[name],
        (name, *key), path, got=got, contexts=d.contexts)


def suite_records(device="cuda", iters=5):
    """The ``kernels``-line records of :func:`suite_record_cases`
    (:func:`build_record` on the ``suites`` path, within 1e-4), taken
    after the counted run."""
    from repro_torch.core.cascade import _full_f32
    from repro_torch.suites import workload as suite
    bench = Bench(device, iters)
    out = []
    with _full_f32(torch.device(device)):
        for name, (wname, n, _, kw), d in suite_record_cases():
            w, mesh, ins = suite.inputs(wname, n, kw, torch.device(device))
            out.append(build_record(bench, name, "workload_suite", w, d,
                                    mesh, ins, "suites"))
            del ins
    return out


def phase_suites(device="cuda", small=False, root=None, iters=5):
    """The reference's five acceptance suites (``repro_torch.suites``) on
    ``device``, with every launch counter at 0 for the whole phase (the
    ``suites`` path): the workload suite (each workload's builds against
    its oracle; on the card moe_dispatch, kv_shuttle, gemm_allgather and
    ring_attention); then telemetry, search_scale and serving on the
    reference's ``V5E`` context (under ``common.left_fold_sum``, the
    summation the checked-in artifacts were written under) whose
    artifacts must equal the root's ``BENCH_search.json``,
    ``BENCH_search_scale.json`` and ``BENCH_serving.json``, with both
    payoffs at least 2x; then the same three and verify on the card's
    ``H100`` model, the port's own artifacts, into ``root``
    (``build/suites/`` of the checkout by default): search wall s a
    candidate, the payoffs, the four serving rows, l0 and l2 ms and their
    ratio against the reference's 0.1 gate. Any failed check raises.
    Returns (the launch counts of the path, the ``kernels``-line records
    of :func:`suite_records`)."""
    from repro_torch.core.hardware import H100, V5E
    from repro_torch.suites import (common, search_scale, serving,
                                    telemetry, verify, workload)
    card = card_label(device)
    cuda = torch.device(device).type == "cuda"
    root = Path(root) if root is not None else ROOT / "build" / "suites"
    kerns = _suite_kernels()
    for k in kerns.values():
        k.reset_launches()
    t0 = time.perf_counter()
    wl = workload.run(device)
    for name, errs in wl["workloads"]:
        log(f"suites workload {name}: host and {len(errs) - 1} builds within "
            f"tol of reference(), max abs err {max(errs.values()):.3e} "
            f"[{card}]")
    with common.left_fold_sum():
        v5e = [(mod, mod.run(device, chip=V5E, out=root / "v5e"
                             / mod.ARTIFACT))
               for mod in (telemetry, search_scale, serving)]
    for mod, r in v5e:
        moved = common.diff(r["artifact"], common.read_json(
            ROOT / mod.ARTIFACT))
        if moved:
            raise SystemExit(f"suites: {mod.ARTIFACT} regenerated on the "
                             f"reference's context differs from the "
                             f"checked-in one at {moved[:6]}")
        log(f"suites {mod.__name__.rsplit('.', 1)[1]} on V5E: {r['out']} "
            f"equals the checked-in {mod.ARTIFACT} [{card}]")
    sc5 = v5e[1][1]
    if not (sc5["warm_payoff"] >= 2 and sc5["transfer_payoff"] >= 2
            and sc5["transfer_gate"] == "met"):
        raise SystemExit(f"suites: V5E payoffs {sc5['warm_payoff']} / "
                         f"{sc5['transfer_payoff']}")
    tel = telemetry.run(device, chip=H100, out=root / telemetry.ARTIFACT)
    sc = search_scale.run(device, chip=H100, out=root / search_scale.ARTIFACT)
    sv = serving.run(device, chip=H100, out=root / serving.ARTIFACT)
    vf = verify.run(device, small=small, out=root / verify.ARTIFACT)
    counts = {}
    for name, k in kerns.items():
        counts.update(_prefixed(name, k.LAUNCHES))
    _contexts_seen("suites", list(kerns.values()))
    for label, r in (("V5E", v5e[0][1]), ("H100", tel)):
        lv = ", ".join(f"{k} {v * 1e3:.3f}"
                       for k, v in r["levels_s_per_candidate"].items())
        log(f"suites telemetry ({label}): {r['evals']} candidates in "
            f"{r['wall_s']:.3f} s, {r['wall_s_per_candidate']:.4f} s a "
            f"candidate (ms a candidate: {lv}); best {r['best_score']:.3f} "
            f"({r['best_t_model_ms']:.4f} ms, {label} model); quarantine "
            f"after {r['quarantine']['elapsed_s']:.2f} s [{card}]")
    for row in tel["probes"]:
        what = row.get("probe") or {}
        log(f"suites probe fused={row['fused']} counter={row['counter']} "
            f"contexts={row['contexts']}: "
            + (f"log of {row['log']['ctas']} CTAs, {row['log']['rounds']} "
               f"rounds -> ok; " if "log" in row else "")
            + (f"probe.check {what['rounds']} rounds, max depth "
               f"{what['max_depth']}, {what['recv_waits']} receive waits"
               if what else "differs from the schedule (a 128 x 128 card "
               "tile holds both 32-row rounds, ROADMAP §3): "
               + row["divergence"]))
    for label, r in (("V5E", sc5), ("H100", sc)):
        ws, tr = r["artifact"]["warm_start"], r["artifact"]["transfer"]
        log(f"suites search_scale ({label}): warm start {ws['cold_evals_to_best']}"
            f" cold evals to best, {ws['warm_fresh_evals_to_best']} fresh "
            f"warm ({r['warm_payoff']:.1f}x, {ws['cache_hits']} cache hits); "
            f"transfer {tr['cold_evals_to_best']} cold, "
            f"{tr['transfer_fresh_evals_to_best']} fresh "
            f"({r['transfer_payoff']:.1f}x, gate {r['transfer_gate']}); "
            f"batched on threads {r['batched_on_threads']}; "
            f"{r['wall_s']:.2f} s [{card}]")
    for row in sv["artifact"]["rows"]:
        log(f"suites serving row (H100 model) {row['name']}: "
            f"{row['us_per_call']:.3f} us, {row['derived']}")
    log(f"suites serving: cascade {sv['cascade']}, two-stream err "
        f"{sv['two_stream_err']:.3e} marks {sv['marks']}; pallas engine == "
        f"host tokens; handoff bit for bit; degrade refused under pallas, "
        f"served on xla [{card}]")
    s = vf["artifact"]["summary"]
    log(f"suites verify: {vf['n_points_ok']} points clean, "
        f"{len(vf['mutations'])} mutation classes caught; l0 mean "
        f"{s['l0_mean_ms']:.4f} ms, l2 mean {s['l2_mean_ms']:.4f} ms on "
        f"{s['l2_device']}: ratio {s['ratio']:.4f} against the gate "
        f"{s['gate_ratio']} -> {s['gate']} [{card}]")
    if cuda and not all(any(k[0] == name for k in counts)
                        for name in kerns):
        raise SystemExit(f"suites: a kernel was not launched: {counts}")
    log(f"suites: {time.perf_counter() - t0:.1f} s [{card}]")
    return counts, suite_records(device, 1 if small else iters)


# ----------------------------------------------------------------- figures

# the figure runs of phase ``figures``: (module, its arguments, table name)
FIGURE_RUNS = (("fig3_flash_attention", {}, "fig3_flash_attention"),
               ("fig4_moe_skew", {"n_dev": 2}, "fig4_moe_skew"),
               ("fig4_moe_skew", {"n_dev": 8}, "fig4_moe_skew_n8"),
               ("fig5_kv_transfer", {}, "fig5_kv_transfer"),
               ("fig6_gemm_allgather", {}, "fig6_gemm_allgather"),
               ("table5_moe_phases", {}, "table5_moe_phases"))


def figure_record_cases(small=False):
    """(kernel, label, workload, its arguments, directive) of phase
    ``figures``' ``kernels``-line records, each at its figure's largest
    measured shape: fig4's skew 5 (n 2) FLUX and DeepEP tight points,
    table5's DeepEP point on the int8 wire, fig5's T 8192 dk 1024 cuco
    point and fig6's 8192 FLUX and DEFERRED points (``small``: the
    figures' test cut)."""
    from repro_torch.figures import common as fc
    from repro_torch.figures import (fig4_moe_skew, fig5_kv_transfer,
                                     fig6_gemm_allgather, table5_moe_phases)
    f4 = fig4_moe_skew.points()
    f6 = dict(fig6_gemm_allgather.POINTS)
    ga = dict(n_dev=4, M=8192, K=8192, N=8192)
    cases = [
        ("moe_dispatch", "fig4_skew5", "moe_dispatch",
         fig4_moe_skew.shape(2, 5.0), f4["flux"]),
        ("moe_dispatch", "fig4_skew5", "moe_dispatch",
         fig4_moe_skew.shape(2, 5.0), f4["deepep_tight"]),
        ("moe_dispatch", "table5", "moe_dispatch", table5_moe_phases.SHAPE,
         table5_moe_phases.points()["deepep_kernel_total_ms"]),
        ("kv_shuttle", "fig5_T8192_dk1024", "kv_transfer",
         dict(T=8192, d=4096, dk=1024), dict(fig5_kv_transfer.POINTS)["cuco"]),
        ("gemm_allgather", "fig6_8192", "gemm_allgather", ga, f6["flux"]),
        ("gemm_allgather", "fig6_8192", "gemm_allgather", ga,
         f6["deferred"])]
    return [(k, label, wname, fc.small_kw(wname, kw)[0] if small else kw, d)
            for k, label, wname, kw, d in cases]


def figure_records(device="cuda", small=False, iters=5):
    """The ``kernels``-line records of :func:`figure_record_cases`
    (:func:`build_record` on the ``figures`` path, on the figure's inputs,
    within 1e-4; 1e-3 on the int8 wire), taken after the counted run."""
    from repro_torch.core.cascade import _full_f32
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.figures import common as fc
    from repro_torch.workloads import get_workload
    bench = Bench(device, iters)
    dev = torch.device(device)
    out = []
    with _full_f32(dev):
        for name, label, wname, kw, d in figure_record_cases(small):
            w = get_workload(wname, **kw)
            ins = fc.inputs(w, dev, 0)
            out.append(build_record(
                bench, name, label, w, d, VirtualMesh(w.n_dev, device=dev),
                ins, "figures", 1e-3 if d.tunable("wire_i8", 0) else 1e-4))
            del ins
    return out


def phase_figures(device="cuda", small=False, root=None, iters=5,
                  artifacts=None):
    """The paper's tables and figures (``repro_torch.figures``) on
    ``device`` with every launch counter at 0 for the whole phase (the
    ``figures`` path): fig3, fig4 at n 2 and 8, fig5, fig6 and table5 on
    the ``H100`` model, each point ``check`` accepts measured at the
    paper's shape through its Hopper kernel (``small``: the figures' test
    cut) and held to its workload's oracle; fig9-13 through the card's
    cascade at ``GENS`` 10 on 4 ranks; ``roofline_cells`` over
    ``artifacts`` (default ``artifacts/dryrun_torch/``). Tables go to
    ``root`` (default ``build/figures/``), one ``bench-rows/v1`` file
    each. For each figure it prints the H100 model and the card side by
    side, whether the card orders each shape's points as the model does,
    and its seconds. A figure module that raises (an output out of its
    tolerance, a kernel point that launched no kernel) stops the phase,
    as does a kernel the path never launched. Returns (the launch counts
    of the path, the ``kernels``-line records of :func:`figure_records`)."""
    import importlib

    from repro_torch.core.hardware import H100
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.figures import common as fc
    from repro_torch.figures import fig9_13_ablations, roofline_cells
    card = card_label(device)
    cuda = torch.device(device).type == "cuda"
    root = Path(root) if root is not None else ROOT / "build" / "figures"
    kerns = _suite_kernels()
    for k in kerns.values():
        k.reset_launches()
    t0 = time.perf_counter()
    for modname, kw, table in FIGURE_RUNS:
        mod = importlib.import_module(f"repro_torch.figures.{modname}")
        t1 = time.perf_counter()
        try:
            rows = mod.run(device, chip=H100, small=small, iters=iters,
                           out=root / f"{table}.json", **kw)
        except Exception as e:
            raise SystemExit(f"figures: {table} raised "
                             f"{type(e).__name__}: {e}") from e
        model = {n: us for n, us, _ in rows}
        measured = [r for r in rows if r[0].endswith("_card")]
        for n, us, derived in measured:
            log(f"figure {n[:-len('_card')]}: H100 model "
                f"{model[n[:-len('_card')]]:.3f} us, card {us:.3f} us "
                f"({derived})")
        for group, mo, me, verdict in fc.orderings(rows, mod.POINT_NAMES):
            log(f"figure order {group}: model {' < '.join(mo)}; card "
                f"{' < '.join(me)} -> {verdict}")
        log(f"figure {table}: {len(rows)} rows, {len(measured)} measured, "
            f"in {time.perf_counter() - t1:.1f} s [{card}]")
    t1 = time.perf_counter()
    for n, v, derived in fig9_13_ablations.run(
            device, chip=H100, mesh=VirtualMesh(4, device=device),
            small=small, out=root / "fig9_13_ablations.json"):
        log(f"figure {n}: {v:.3f} ({derived})")
    log(f"figure fig9_13_ablations: {time.perf_counter() - t1:.1f} s "
        f"[{card}]")
    cells = roofline_cells.run(device, out=root / "roofline_cells.json",
                               artifacts=artifacts)
    for n, us, derived in cells:
        log(f"figure {n}: {us:.3f} us ({derived}; H100 model)")
    log(f"figure roofline_cells: {len(cells)} cells from "
        f"{artifacts or roofline_cells.ARTIFACTS}")
    counts = {}
    for name, k in kerns.items():
        counts.update(_prefixed(name, k.LAUNCHES))
    _contexts_seen("figures", list(kerns.values()))
    if cuda and not all(any(k[0] == name for k in counts)
                        for name in kerns):
        raise SystemExit(f"figures: a kernel was not launched: {counts}")
    log(f"figures: {time.perf_counter() - t0:.1f} s, tables in {root} "
        f"[{card}]")
    return counts, figure_records(device, small, 1 if small else iters)


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
    phase_gemm_core("cuda", iters=args.iters)
    phase_ga_core("cuda", iters=args.iters)
    records = phase_kernels("cuda", iters=args.iters)
    records += phase_kv_kernels("cuda", iters=args.iters)
    records += phase_ga_kernels("cuda", iters=args.iters)
    records += phase_attn_kernels("cuda", iters=args.iters)
    records += phase_moe_model_kernels("cuda", iters=args.iters)
    records += phase_serve_kernels("cuda", iters=args.iters)
    records += phase_tp_kernels("cuda", iters=args.iters)
    phase_window("cuda", iters=args.iters)
    counted = {"main": phase_main("cuda")}
    counted["scmoe"], scmoed = phase_scmoe("cuda", iters=args.iters)
    records += scmoed
    counted["kv_main"] = phase_kv_main("cuda")
    counted["serve"] = phase_serve("cuda")
    counted["ga_main"] = phase_ga_main("cuda")
    counted["ring_main"], deployed = phase_ring_main("cuda", iters=args.iters)
    records += deployed
    phase_ring_split("cuda", iters=args.iters)
    counted["slow_main"] = phase_slow_main("cuda")
    counted["serve_moe"] = phase_serve_moe("cuda")
    counted["faults"], faulted = phase_faults("cuda", iters=args.iters)
    records += faulted
    phase_serve_degrade("cuda")
    counted["serve_kinds"] = phase_serve_kinds("cuda")
    counted["serve_mixed"] = phase_serve_mixed("cuda")
    counted["serve_tp"] = phase_serve_tp("cuda")
    counted["train"] = phase_train("cuda")
    phase_dryrun("cuda", artifacts=ROOT / "artifacts" / "dryrun_torch")
    counted["examples"] = phase_examples("cuda")
    counted["suites"], suited = phase_suites("cuda", iters=args.iters)
    records += suited
    counted["figures"], figured = phase_figures("cuda", iters=args.iters)
    records += figured
    for path, counts in counted.items():
        log(f"launches on the {path} path: {counts}")
    for rec in records:
        rec["launches"] = counted[rec.pop("_path")].get(rec.pop("_key"), 0)
        if rec["launches"] == 0:
            raise SystemExit(f"{rec['name']} was not launched on its "
                             "counted path")
    log(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
