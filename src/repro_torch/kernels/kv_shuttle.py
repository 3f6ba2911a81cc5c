"""KV-cache shuttle for disaggregated prefill->decode serving (paper
workload 3, Table 4 row 3) as a hand-written Hopper kernel
(``repro_torch/csrc/kv_shuttle.cu``).

Port of ``repro/kernels/kv_shuttle.py``: the ``n = 2`` degenerate ring of
:class:`~repro_torch.core.schedule.RingSchedule`. The prefill rank (rank 0)
computes K = x@Wk, sends it, computes V = x@Wv while K is on the wire and
sends V (``chained``); the sequential shape drains K's send before the V
GEMM starts. TILE_FUSED (``fused``) runs the projections as
``kv_chunk``-row tiles, each sent as soon as it is done, and the decode
rank (rank 1) ticks arrivals off one chunk at a time (``counter``) or
drains every chunk per edge (SIGNAL). ``pure`` mode ships finished
``[K; V]`` cache rows verbatim — the engine's cache handoff.

Every entry takes and returns the JAX package's stacked layout, ranks on
axis 0 (no mesh argument): outputs ``(2, rows, w)`` whose row 0 (the
prefill rank's, never written by the kernel) is zeros, as the JAX entry
points mask it. CUDA tensors launch the kernel or raise; CPU tensors
compute :func:`kv_shuttle_plain`, the plain version the tests and
``chip_smoke.py`` hold the kernel against. ``contexts`` (1, 2 or 4) is
the kernel's send window: each prefill CTA keeps that many work units (a
GEMM tile or a row copy) of bulk stores in flight (``csrc/window.cuh``);
:func:`kv_shuttle_logged` runs the probe build and :func:`check_log`
holds its log to the unit order and ``RingSchedule``'s ticks.
``LAUNCHES`` counts launches keyed by variant and shape
(``CONTEXTS_LAUNCHED`` by ``contexts``, ``CORE_LAUNCHES`` by the tile
core: :func:`core_for`); ``VARIANTS`` / ``PURE_VARIANTS`` name the knob
sets the main path launches. :func:`gemm_core` runs the ``wgmma`` core
alone.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core import telemetry
from repro_torch.kernels import build, window

# The schedule machinery is defined once, in repro_torch.core.schedule;
# re-exported here for the kernel's callers.
from repro_torch.core.schedule import (RingSchedule,  # noqa: F401
                                       make_ring_schedule)

# contexts -> kernel launches: the directives' window reaches the card
CONTEXTS_LAUNCHED = collections.Counter()

TIMEOUT_MS = 20_000           # a spin-wait traps after this long
COPY_UNIT_BYTES = 32 * 1024   # pure mode: bytes one CTA copies per unit
DEFAULT_CHUNK = 64            # fused kv_chunk when none is given

# (variant, rows, width, dtype) -> kernel launches; read by chip_smoke.py
LAUNCHES = collections.Counter()

# The kernels of csrc/kv_shuttle.cu by the core they run (its CORE_*
# ids): aligned projections on the Hopper ``wgmma`` core
# (csrc/wg_tile.cuh), unaligned ones on tc_gemm.cuh's ``mma_sync`` tile,
# pure mode's row ``copy``; a GEMM unit's rows on each core
CORE_IDS = {"wgmma": 0, "copy": 1, "mma_sync": 2}
TILE_ROWS = {"wgmma": 128, "mma_sync": 64}
# core -> kernel launches
CORE_LAUNCHES = collections.Counter()

# Knobs of each variant the main path launches: the KVTransfer search's
# directives (GEMM variants) and the engine's two cache handoffs (pure).
VARIANTS = {
    "sequential": dict(chained=False),
    "chained": dict(chained=True),
    "fused_signal": dict(fused=True, counter=False, kv_chunk=64),
    "fused_counter": dict(fused=True, counter=True, kv_chunk=64),
    "fused_counter_kc32": dict(fused=True, counter=True, kv_chunk=32),
}
PURE_VARIANTS = {
    "pure_chained": dict(chained=True),
    "pure_fused_counter_kc1024": dict(fused=True, counter=True,
                                      kv_chunk=1024),
}


def reset_launches():
    LAUNCHES.clear()
    CONTEXTS_LAUNCHED.clear()
    CORE_LAUNCHES.clear()


def launches():
    """Kernel launches so far, all variants."""
    return sum(LAUNCHES.values())


def _schedule(rows, fused, kv_chunk):
    return make_ring_schedule(
        2, rows, kv_chunk or (DEFAULT_CHUNK if fused else rows), fused)


def variant_name(*, chained=True, fused=False, counter=False, kv_chunk=None,
                 pure=False, rows):
    """The variant a call launches: the realization, plus ``_kc<rows>``
    for a fused chunk other than 64 rows (after sanitizing against
    ``rows``)."""
    if fused:
        name = "fused_counter" if counter else "fused_signal"
        kc = _schedule(rows, True, kv_chunk).kv_chunk
        if kc != DEFAULT_CHUNK:
            name += f"_kc{kc}"
    else:
        name = "chained" if chained else "sequential"
    return ("pure_" if pure else "") + name


def _shape(x, wk, *, pure, fused, kv_chunk, contexts):
    """Check the layout and the knobs; ``(rows, width, schedule)``."""
    if x.dim() != 3 or x.shape[0] != 2:
        raise ValueError(f"the shuttle wants the stacked (2, rows, w) layout, "
                         f"got {tuple(x.shape)}")
    window.check_contexts(contexts)
    if pure:
        if x.shape[1] % 2:
            raise ValueError("pure shuttle wants stacked [K; V] rows, got "
                             f"{x.shape[1]} rows")
        rows, width = x.shape[1] // 2, x.shape[2]
    else:
        rows, width = x.shape[1], wk.shape[1]
    return rows, width, _schedule(rows, fused, kv_chunk)


# ------------------------------------------------------------ plain version


def kv_shuttle_plain(x, wk=None, wv=None, *, chained=True, fused=False,
                     counter=False, kv_chunk=None, contexts=2, pure=False):
    """Plain-torch version of the kernel on the stacked layout. x (2, T, d)
    (rank 0's rows are the prefill activations), wk/wv (d, dk) -> K, V each
    (2, T, dk) in x's dtype, f32 accumulation; ``pure``: x is the stacked
    cache (2, 2N, w) -> K, V each (2, N, w), copied verbatim. Row 0 of
    each output is zeros. The realization knobs change when rows move,
    never what lands, so they are only checked here."""
    rows, width, _ = _shape(x, wk, pure=pure, fused=fused, kv_chunk=kv_chunk,
                            contexts=contexts)
    if pure:
        k, v = x[0, :rows], x[0, rows:]
    else:
        src = x[0].to(torch.float32)
        k = (src @ wk.to(torch.float32)).to(x.dtype)
        v = (src @ wv.to(torch.float32)).to(x.dtype)
    ko = x.new_zeros((2, rows, width))
    vo = x.new_zeros((2, rows, width))
    ko[1], vo[1] = k, v
    return ko, vo


# ------------------------------------------------------------ the kernel


class _Params(ctypes.Structure):
    """``ShuttleParams`` of ``csrc/kv_shuttle.cu``, field for field."""
    _fields_ = (
        [(k, ctypes.c_int) for k in (
            "rows", "d", "dk", "chunk_rows", "nchunks", "fused", "chained",
            "counter", "pure", "vec", "esize", "unit_rows", "timeout_ms",
            "contexts", "log_cap")]
        + [(k, ctypes.c_void_p) for k in ("x", "wk", "wv", "ko", "vo", "flag")]
        + [("slot", window.LogOrStats), ("log_n", ctypes.c_void_p)])
    _anonymous_ = ("slot",)

# the kernel's CTA roles, in the order of its ``stats`` accumulator's rows
STAT_ROLES = ("prefill", "decode")


def load_kernel(probe=False, stats=False):
    """Build (if needed) and load the kernel without running it — the
    fast path's stage A and the cascade's l1. ``probe``: the build with
    ``-DCUCO_PROBE``, which logs its window (:func:`check_log`);
    ``stats``: the counting build (``build.STATS_DEFINES``), which one
    traced launch in 17 takes (``telemetry.kernel_counters``), built
    together with the production build so that a traced launch never
    waits for ``nvcc``; its failure does not fail the production build."""
    if probe:
        return build.load_typed("kv_shuttle", _Params, grid_args=1,
                                defines=window.PROBE_DEFINES)
    return build.load_typed("kv_shuttle", _Params, grid_args=1,
                            defines=build.STATS_DEFINES if stats else (),
                            together=((), build.STATS_DEFINES))


def core_for(x, wk=None, wv=None, *, pure=False):
    """The core a launch on these operands runs (:data:`CORE_IDS`): pure
    mode's ``copy``; ``wgmma`` where d and dk are multiples of 4 and x,
    wk and wv start on 16 bytes (what TMA takes; the outputs, allocated
    here, then do too); else ``mma_sync``. Decided by the operands alone."""
    if pure:
        return "copy"
    aligned = x.shape[2] % 4 == 0 and wk.shape[1] % 4 == 0 \
        and _aligned(x, wk, wv)
    return "wgmma" if aligned else "mma_sync"


def grid_for(device, core="wgmma", probe=False, stats=False):
    """The co-resident grid of a core's kernel (:data:`CORE_IDS`): CTAs
    per SM x SMs, one of them the decode rank's. Raises when fewer than
    two CTAs fit. The production grid preloads the counting build's
    (:func:`build.preload`), so that a traced launch waits for no module
    load."""
    got = build.grid(load_kernel(probe, stats), device, CORE_IDS[core])
    if not probe and not stats:
        build.preload("kv_shuttle", lambda: load_kernel(stats=True), device,
                      CORE_IDS[core])
    return got


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(x, wk, wv, *, chained, fused, counter, kv_chunk, contexts, pure,
            probe=False):
    """One launch on ``x``'s card, in three spans: ``kv_shuttle.prepare``
    (the checks, the grid, the ``_Params`` pack), ``kv_shuttle.alloc``
    (K / V, the prefill rows' zero fill, the flags) and
    ``kv_shuttle.launch``. Returns ``(ko, vo)``, or with ``probe`` (the
    ``-DCUCO_PROBE`` build, uncounted) ``(ko, vo, (log, grid, unit_rows,
    core))``."""
    with telemetry.span("kv_shuttle.prepare"):
        rows, width, sched = _shape(x, wk, pure=pure, fused=fused,
                                    kv_chunk=kv_chunk, contexts=contexts)
        chunk_rows = sched.kv_chunk if fused else rows
        operands = [x] if pure else [x, wk, wv]
        for t in operands:
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"kv_shuttle wants contiguous tensors on "
                                 f"{x.device}; got one on {t.device}")
        if not pure:
            if any(t.dtype != torch.float32 for t in operands):
                raise ValueError("kv_shuttle's projections take float32 x, "
                                 "wk and wv; got "
                                 + ", ".join(str(t.dtype) for t in operands))
            if wk.shape != (x.shape[2], width) or wv.shape != wk.shape:
                raise ValueError(f"wk {tuple(wk.shape)}, wv "
                                 f"{tuple(wv.shape)} do not project x "
                                 f"{tuple(x.shape)}")
        if chunk_rows * width >= 2**32:
            raise ValueError(f"a chunk of {chunk_rows} x {width} elements "
                             "overflows its 32-bit flag")
        # while a profiler records: the counting build and its counters
        stats = None if probe else telemetry.kernel_counters(
            "kv_shuttle_kernel", STAT_ROLES, x.device)
        core = core_for(x, wk, wv, pure=pure)
        grid, _ = grid_for(x.device, core, probe, stats is not None)
        nchunks = rows // chunk_rows
        esize = x.element_size()
        if pure:
            vec = (width * esize) % 16 == 0 and _aligned(x)
        else:
            vec = core == "wgmma"
        unit_rows = max(1, COPY_UNIT_BYTES // (width * esize))
        p = _Params(rows=rows, d=0 if pure else x.shape[2], dk=width,
                    chunk_rows=chunk_rows, nchunks=nchunks, fused=int(fused),
                    chained=int(chained), counter=int(counter),
                    pure=int(pure), vec=int(vec), esize=esize,
                    unit_rows=unit_rows, timeout_ms=TIMEOUT_MS,
                    contexts=int(contexts),
                    x=x.data_ptr(), wk=None if pure else wk.data_ptr(),
                    wv=None if pure else wv.data_ptr(),
                    stats=None if stats is None else stats.data_ptr())
    with telemetry.span("kv_shuttle.alloc"):
        ko = torch.empty((2, rows, width), dtype=x.dtype, device=x.device)
        vo = torch.empty_like(ko)
        ko[0].zero_()             # the prefill rank's rows: never written
        vo[0].zero_()
        flags = torch.zeros(2 * nchunks, dtype=torch.int32, device=x.device)
        p.ko, p.vo = ko[1].data_ptr(), vo[1].data_ptr()
        p.flag = flags.data_ptr()
        # the probe build logs its window; the production build writes no
        # log and keeps null log pointers
        if probe:
            total = len(_units(rows, width, chunk_rows, fused, pure,
                               unit_rows, core))
            log = window.DeviceLog.alloc(
                grid, 2 * -(-total // (grid - 1)) + nchunks + 8, x.device)
            for k, v in log.params().items():
                setattr(p, k, v)
    with telemetry.span("kv_shuttle.launch"):
        build.launch(load_kernel(probe, stats is not None), p, x.device,
                     grid)
    if probe:   # not a launch of the counted paths
        return ko, vo, (log, grid, unit_rows, core)
    CONTEXTS_LAUNCHED[int(contexts)] += 1
    CORE_LAUNCHES[core] += 1
    LAUNCHES[(variant_name(chained=chained, fused=fused, counter=counter,
                           kv_chunk=kv_chunk, pure=pure, rows=rows),
              rows, width, str(x.dtype).replace("torch.", ""))] += 1
    # the flags are freed here; the caching allocator reuses them only in
    # this stream's order, after the launch
    return ko, vo


def _entry(x, wk, wv, *, chained, fused, counter, kv_chunk, contexts, pure):
    if x.device.type == "cpu":
        return kv_shuttle_plain(x, wk, wv, chained=chained, fused=fused,
                                counter=counter, kv_chunk=kv_chunk,
                                contexts=contexts, pure=pure)
    if x.device.type != "cuda":
        raise ValueError(f"kv_shuttle runs on cuda or cpu, not {x.device}")
    with telemetry.span("kv_shuttle.call"):
        return _launch(x, wk, wv, chained=chained, fused=fused,
                       counter=counter, kv_chunk=kv_chunk, contexts=contexts,
                       pure=pure)


def kv_shuttle(x, wk, wv, *, chained=True, fused=False, counter=False,
               kv_chunk=None, contexts=2):
    """Global entry, the JAX package's layout: x (2, T, d), rank 0 holding
    the prefill activations; wk/wv (d, dk) replicated. Returns K, V each
    (2, T, dk); row 1 (the decode rank) holds the shuttled projections."""
    return _entry(x, wk, wv, chained=chained, fused=fused, counter=counter,
                  kv_chunk=kv_chunk, contexts=contexts, pure=False)


def kv_cache_shuttle(kv, *, chained=True, fused=False, counter=False,
                     kv_chunk=None, contexts=2):
    """Global cache-handoff entry (``serve/engine.py::prefill_remote``).
    kv: (2, 2N, w) — rank 0's row holds the finished cache stacked
    ``[K; V]``, rank 1's is zeros. Returns K, V each (2, N, w); row 1 (the
    decode rank) holds the shuttled cache, bit for bit."""
    return _entry(kv, None, None, chained=chained, fused=fused,
                  counter=counter, kv_chunk=kv_chunk, contexts=contexts,
                  pure=True)


def gemm_core(x, wk, wv):
    """The ``wgmma`` core alone (``kv_shuttle_gemm`` of the library):
    ``(x @ wk, x @ wv)`` for x (rows, d) and the weights (d, dk), float32
    and aligned as the core takes them (:func:`core_for`), in the chained
    shuttle's units over one CTA an SM, with no flag, window or decode
    CTA: for the tests and ``chip_smoke.py``'s ``gemm_core`` line. CPU
    tensors compute the plain product."""
    if x.device.type == "cpu":
        return x @ wk, x @ wv
    if x.dim() != 2 or wk.shape != (x.shape[1], wk.shape[1]) \
            or wv.shape != wk.shape:
        raise ValueError(f"gemm_core wants x (rows, d) and two (d, dk) "
                         f"weights, got {tuple(x.shape)}, "
                         f"{tuple(wk.shape)}, {tuple(wv.shape)}")
    for t in (x, wk, wv):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("gemm_core wants contiguous float32 tensors on "
                             f"{x.device}; got {t.dtype} on {t.device}")
    if core_for(x[None], wk, wv) != "wgmma":
        raise ValueError("gemm_core wants d and dk multiples of 4 and "
                         "16-byte aligned operands")
    (rows, d), dk = x.shape, wk.shape[1]
    ko = torch.empty((rows, dk), device=x.device)
    vo = torch.empty_like(ko)
    grid, _ = grid_for(x.device)
    p = _Params(rows=rows, d=d, dk=dk, chunk_rows=rows, nchunks=1,
                chained=1, vec=1, timeout_ms=TIMEOUT_MS, contexts=1,
                x=x.data_ptr(), wk=wk.data_ptr(), wv=wv.data_ptr(),
                ko=ko.data_ptr(), vo=vo.data_ptr())
    lib = load_kernel()
    fn = lib.kv_shuttle_gemm
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        build._check(lib, fn(ctypes.byref(p), grid, torch.cuda.current_stream(
            x.device).cuda_stream), "gemm_core launch")
    return ko, vo


# ------------------------------------------------------------ the op recorder


def _units(rows, width, chunk_rows, fused, pure, unit_rows, core="wgmma"):
    """The half of each work unit, in the kernel's round order (its CTAs
    take them round robin): GEMM tiles of ``TILE_ROWS[core]`` x 128 (a
    row group's K tiles, then its V tiles; unfused all of K first) or,
    ``pure``, row copies of ``unit_rows`` rows (chunk-major when fused)."""
    if pure:
        upc = -(-chunk_rows // unit_rows)
        nchunks = rows // chunk_rows
        if fused:
            return [(u % (2 * upc)) // upc for u in range(2 * nchunks * upc)]
        return [u // upc for u in range(2 * upc)]
    bm = TILE_ROWS[core]
    rt, ctn = -(-rows // bm), -(-width // 128)
    tpg = rt if not fused else (chunk_rows // bm if chunk_rows % bm == 0
                                else 1)
    per_group = 2 * tpg * ctn
    return [(u % per_group) // (tpg * ctn) for u in range(2 * rt * ctn)]


def kv_shuttle_logged(x, wk=None, wv=None, *, pure=False, contexts=2,
                      **knobs):
    """The probe build (``-DCUCO_PROBE``) on CUDA tensors at the full
    grid: ``(ko, vo, events, meta)``, ``events`` each CTA's decoded window
    log and ``meta`` what :func:`check_log` needs. Takes the entries'
    knobs; not counted in ``LAUNCHES``."""
    if x.device.type != "cuda":
        raise ValueError(f"the probe build is a kernel build; {x.device} "
                         "has none")
    knobs = dict(dict(chained=True, fused=False, counter=False,
                      kv_chunk=None), **knobs)
    ko, vo, (log, grid, unit_rows, core) = _launch(
        x, wk, wv, contexts=contexts, pure=pure, probe=True, **knobs)
    rows, width, sched = _shape(x, wk, pure=pure, fused=knobs["fused"],
                                kv_chunk=knobs["kv_chunk"], contexts=contexts)
    meta = dict(rows=rows, width=width, pure=pure, unit_rows=unit_rows,
                grid=grid, contexts=contexts, core=core, **knobs)
    return ko, vo, window.decode(log.events, log.counts), meta


def check_log(events, *, rows, width, pure, unit_rows, grid, contexts,
              chained=True, fused=False, counter=False, kv_chunk=None,
              core="wgmma"):
    """Hold a probe launch's log to the window contract. The card's round
    is a work unit, a piece of the schedule's ``(0, chunk)`` round (a
    chunk's tiles go to several CTAs): each prefill CTA pushes its units
    ``(half, u)`` in the round order, drains before a sequential K drain
    and at the end; together they push every unit; the decode CTA's
    receive waits (one a K / V chunk pair) are the n = 2 ring's
    ``completion_ticks``. Returns the window summary of the prefill
    CTAs. ``core`` (:data:`CORE_IDS`) sets a GEMM unit's rows."""
    del counter
    sched = _schedule(rows, fused, kv_chunk)
    chunk_rows = sched.kv_chunk if fused else rows
    halves = _units(rows, width, chunk_rows, fused, pure, unit_rows, core)
    order = [(h, u) for u, h in enumerate(halves)]
    npre = grid - 1
    stats = []
    for pid in range(npre):
        where = f"kv_shuttle CTA {pid}: "
        st = window.check_cta(events[pid], contexts, order, where)
        mine = order[pid::npre]
        drains = 1 + int(not fused and not chained
                         and any(h for h, _ in mine))
        if window.pushed(events[pid]) != mine or st["drains"] != drains:
            raise window.WindowLogError(
                f"{where}pushed {st['rounds']} units and {st['drains']} "
                f"drains, not its {len(mine)} and {drains}")
        stats.append(st)
    window.check_rank(events[:npre], order, where="kv_shuttle: ")
    ticks = make_ring_schedule(2, rows, chunk_rows, fused).completion_ticks()
    window.check_rank([events[npre]], [], ticks, where="kv_shuttle decode: ")
    return window.summary(stats)
