"""Fused GEMM + AllGather (paper workload 4) as a hand-written Hopper kernel
(``repro_torch/csrc/gemm_allgather.cu``).

Port of ``repro/kernels/gemm_allgather.py``: every rank computes
``C_r = A_r @ B`` and stores it into every rank's output at rows
``[r*M_l, (r+1)*M_l)``. TILE_FUSED (``fused``) broadcasts each GEMM tile
the moment it is done; DEFERRED ships the whole slab per peer after the
rank's GEMM. COUNTER (``counter``, fused only) waits per ``tile_m`` chunk;
SIGNAL and DEFERRED wait once per inbound edge. The n ranks are n CTA
partitions of one cooperative launch (no mesh collective runs).

Every entry takes and returns the JAX package's stacked layout, ranks on
axis 0: a ``(n, M_l, K)``, b ``(K, N)`` replicated, the result
``(n, n*M_l, N)``. CUDA tensors launch the kernel or raise; CPU tensors
compute :func:`gemm_allgather_plain`, the plain version the tests and
``chip_smoke.py`` hold the kernel against. ``contexts`` (1, 2 or 4) is
the kernel's send window: each CTA keeps that many ``(offset, tile)``
rounds of bulk stores in flight (``csrc/window.cuh``). ``probe=`` (a
``ScheduleProbe``) records the round program: on CPU tensors the
reference's issue / retire / receive order, walked through
``core/schedule.py::SendWindow``; on CUDA tensors the probe build's log
at one CTA a rank (:func:`record_card`). :func:`gemm_allgather_logged`
and :func:`check_log` hold the full grid's logs. ``LAUNCHES`` counts
launches keyed by variant and shape (``CONTEXTS_LAUNCHED`` by
``contexts``); ``VARIANTS`` names the knob sets the main path launches.

The kernel splits its operands into TF32 hi / lo once per call, into
scratch the wrapper allocates (:func:`scratch_shapes`: A and B^T,
zero-padded to whole tiles, one replica of B^T a rank);
:func:`split_operands` runs that phase alone and
:func:`split_operands_plain` is its plain version.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build, window

# The schedule machinery is defined once, in repro_torch.core.schedule;
# re-exported here for the kernel's callers.
from repro_torch.core.schedule import (BroadcastSchedule,  # noqa: F401
                                       SendWindow, make_broadcast_schedule,
                                       sanitize_tile_m)

TIMEOUT_MS = 20_000           # a spin-wait traps after this long
DEFAULT_TILE_M = 128
# the kernel's GEMM tile (csrc/wgmma_gemm.cuh: BM, BN, BK): the scratch is
# padded to whole tiles
TILE_M, TILE_N, TILE_K = 128, 128, 32

# (variant, n, M_l, K, N) -> kernel launches; read by chip_smoke.py
LAUNCHES = collections.Counter()
# contexts -> kernel launches: the directives' window reaches the card
CONTEXTS_LAUNCHED = collections.Counter()

# Knobs of each variant the main path launches (the GemmAllGather search's
# directives at M_l = 1024).
VARIANTS = {
    "deferred": dict(fused=False, counter=False),
    "fused_signal": dict(fused=True, counter=False),
    "fused_counter": dict(fused=True, counter=True),
    "fused_counter_tm32": dict(fused=True, counter=True, tile_m=32),
}


def reset_launches():
    LAUNCHES.clear()
    CONTEXTS_LAUNCHED.clear()


def launches():
    """Kernel launches so far, all variants."""
    return sum(LAUNCHES.values())


def variant_name(*, fused=True, counter=False, tile_m=DEFAULT_TILE_M, M_l):
    """The variant a call launches: the realization, plus ``_tm<rows>``
    for a COUNTER chunk other than 128 rows (after sanitizing against
    ``M_l``). Only COUNTER waits per chunk, so only it names one."""
    if not fused:
        return "deferred"
    if not counter:
        return "fused_signal"
    tm = sanitize_tile_m(tile_m, M_l)
    return "fused_counter" + ("" if tm == DEFAULT_TILE_M else f"_tm{tm}")


def _shape(a, b, *, tile_m, contexts):
    """Check the layout and the knobs; ``(n, M_l, K, N, tile_m)``."""
    if a.dim() != 3 or b.dim() != 2 or a.shape[2] != b.shape[0]:
        raise ValueError(f"gemm_allgather wants a (n, M_l, K) and b (K, N), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    window.check_contexts(contexts)
    n, M_l, K = a.shape
    return n, M_l, K, b.shape[1], sanitize_tile_m(tile_m, M_l)


# ------------------------------------------------------------ plain version


def gemm_allgather_plain(a, b, *, tile_m=DEFAULT_TILE_M, fused=True,
                         counter=False, contexts=2):
    """Plain-torch version of the kernel on the stacked layout: a
    (n, M_l, K), b (K, N) -> (n, n*M_l, N), every rank holding the whole
    gathered product, f32 accumulation, in a's dtype. The realization
    knobs change when rows move, never what lands, so they are only
    checked here."""
    n, M_l, K, N, _ = _shape(a, b, tile_m=tile_m, contexts=contexts)
    c = (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)
    return c.reshape(n * M_l, N)[None].expand(n, n * M_l, N).contiguous()


def _up(x, tile):
    return -(-x // tile) * tile


def padded(M_l, K, N):
    """``(M_p, K_p, N_p)``: M_l, K and N padded to whole GEMM tiles."""
    return _up(M_l, TILE_M), _up(K, TILE_K), _up(N, TILE_N)


def scratch_shapes(n, M_l, K, N):
    """Shapes of the split scratch: ``(2, n, M_p, K_p)`` (each rank's A as
    TF32 hi, then lo) and ``(2, n, N_p, K_p)`` (each rank's B^T)."""
    M_p, K_p, N_p = padded(M_l, K, N)
    return (2, n, M_p, K_p), (2, n, N_p, K_p)


def split_tf32_plain(x):
    """``(hi, lo)`` of float32 ``x``, as the kernel splits it (``mma.cuh``'s
    ``split_tf32``): hi rounds x to TF32 (half an ulp added to the
    magnitude's bits, the 13 low bits cleared), lo = x - hi, exact."""
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def split_operands_plain(a, b):
    """Plain version of :func:`split_operands`: a (n, M_l, K), b (K, N)
    float32 -> the scratch of :func:`scratch_shapes`, zero-padded."""
    n, M_l, K = a.shape
    N = b.shape[1]
    shape_a, shape_b = scratch_shapes(n, M_l, K, N)
    pa = a.new_zeros(shape_a[1:])
    pa[:, :M_l, :K] = a
    pb = b.new_zeros(shape_b[2:])
    pb[:N, :K] = b.t()
    return (torch.stack(split_tf32_plain(pa)),
            torch.stack(split_tf32_plain(pb))[:, None].expand(shape_b)
            .contiguous())


# ------------------------------------------------------------ the kernel


class _Params(ctypes.Structure):
    """``GaParams`` of ``csrc/gemm_allgather.cu``, field for field."""
    _fields_ = (
        [(k, ctypes.c_int) for k in (
            "n", "M_l", "K", "N", "M_p", "K_p", "N_p", "chunk_rows",
            "nchunks", "fused", "vec", "per_rank", "timeout_ms", "contexts",
            "log_cap")]
        + [(k, ctypes.c_void_p) for k in (
            "a", "b", "out", "sa", "sb", "flag", "done", "split", "log",
            "log_n")])


def load_kernel(defines=()):
    """Build (if needed) and load the kernel without running it — the
    fast path's stage A and the cascade's l1. ``defines``: ``-D`` tuning
    knobs of a build other than the production one (``GA_PART_STAGES``,
    ``GA_GROUP_M``; :func:`launch_built_with`)."""
    return build.load_typed("gemm_allgather", _Params, grid_args=1,
                            defines=defines)


def grid_for(device, n, defines=()):
    """The co-resident grid the launch uses for ``n`` ranks: CTAs per SM x
    SMs, rounded down to a multiple of n. Raises when a rank would get no
    CTA."""
    return build.grid(load_kernel(defines), device, int(n))


def smem_bytes():
    """Dynamic shared memory of one CTA of the kernel (bytes)."""
    return load_kernel().gemm_allgather_smem_bytes()


def _check_tensors(a, b):
    for t in (a, b):
        if t.device != a.device or not t.is_contiguous() \
                or t.dtype != torch.float32:
            raise ValueError(f"gemm_allgather wants contiguous float32 "
                             f"tensors on {a.device}; got {t.dtype} on "
                             f"{t.device}")


def log_cap(n, M_l, N, per_rank, nchunks):
    """Events one CTA logs at most: a push and a retire a round (a tile
    and peer, or a DEFERRED share), its share of the receive waits, a
    drain, and room to spare."""
    M_p, _, N_p = padded(M_l, TILE_K, N)
    tiles = -(-(M_p // TILE_M) * (N_p // TILE_N) // per_rank)
    return 2 * max(n - 1, 1) * tiles + (n - 1) * nchunks + 8


def _params(a, b, out, chunk_rows, fused, defines=(), contexts=1,
            grid=None):
    """``(params, grid, keep)``: the launch's parameters, its grid and the
    tensors they point into (the scratch, the flags and, in a probe build,
    the log: freed when ``keep`` goes, which the caching allocator reuses
    only in this stream's order, after the launch). ``grid``: a multiple
    of n below the co-resident grid (the probe's one CTA a rank)."""
    (n, M_l, K), N = a.shape, b.shape[1]
    full, _ = grid_for(a.device, n, defines)
    grid = full if grid is None else int(grid)
    if grid % n or not n <= grid <= full:
        raise ValueError(f"a grid of {grid} CTAs does not split over {n} "
                         f"ranks within the co-resident {full}")
    shape_a, shape_b = scratch_shapes(n, M_l, K, N)
    sa = torch.empty(shape_a, dtype=torch.float32, device=a.device)
    sb = torch.empty(shape_b, dtype=torch.float32, device=a.device)
    nchunks = M_l // chunk_rows
    flags = torch.zeros(n * n * nchunks + 2 * n, dtype=torch.int32,
                        device=a.device)
    vec = K % 4 == 0 and N % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (a, b) + (() if out is None
                                                  else (out,)))
    M_p, K_p, N_p = padded(M_l, K, N)
    words = flags.data_ptr() + 4 * n * n * nchunks
    probe = window.PROBE_DEFINES[0] in defines
    log = window.DeviceLog.alloc(
        grid if probe else 1,
        log_cap(n, M_l, N, grid // n, nchunks) if probe else 1, a.device)
    p = _Params(n=n, M_l=M_l, K=K, N=N, M_p=M_p, K_p=K_p, N_p=N_p,
                chunk_rows=chunk_rows, nchunks=nchunks, fused=int(fused),
                vec=int(vec), per_rank=grid // n, timeout_ms=TIMEOUT_MS,
                contexts=int(contexts),
                a=a.data_ptr(), b=b.data_ptr(),
                out=None if out is None else out.data_ptr(),
                sa=sa.data_ptr(), sb=sb.data_ptr(), flag=flags.data_ptr(),
                done=words, split=words + 4 * n, **log.params())
    return p, grid, (sa, sb, flags, log)


def _launch(a, b, *, tile_m, fused, counter, contexts, defines=(),
            grid=None):
    n, M_l, K, N, tm = _shape(a, b, tile_m=tile_m, contexts=contexts)
    _check_tensors(a, b)
    if M_l * N >= 2**32:
        raise ValueError(f"a {M_l} x {N} slab overflows its 32-bit flag")
    out = torch.empty((n, n * M_l, N), dtype=a.dtype, device=a.device)
    p, grid, keep = _params(a, b, out, tm if fused and counter else M_l,
                            fused, defines, contexts, grid)
    build.launch(load_kernel(defines), p, a.device, grid)
    if window.PROBE_DEFINES[0] in defines:   # not a launch of the counted paths
        return out, keep[-1]
    LAUNCHES[(variant_name(fused=fused, counter=counter, tile_m=tile_m,
                           M_l=M_l), n, M_l, K, N)] += 1
    CONTEXTS_LAUNCHED[int(contexts)] += 1
    return out


def split_operands(a, b):
    """The kernel's split phase alone (``gemm_allgather_split``: the same
    launch, ending after each rank's split), for the tests and
    ``chip_smoke.py``'s ``ga_core`` line: a (n, M_l, K), b (K, N) float32
    -> the scratch of :func:`scratch_shapes`. CUDA tensors launch (or
    raise); CPU tensors compute :func:`split_operands_plain`. Not counted
    in ``LAUNCHES``."""
    _shape(a, b, tile_m=DEFAULT_TILE_M, contexts=1)
    if a.device.type == "cpu":
        return split_operands_plain(a, b)
    _check_tensors(a, b)
    p, grid, (sa, sb, _flags, _log) = _params(a, b, None, a.shape[1], True)
    lib = load_kernel()
    fn = lib.gemm_allgather_split
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(a.device):
        build._check(lib, fn(ctypes.byref(p), grid, torch.cuda.current_stream(
            a.device).cuda_stream), "split launch")
    return sa, sb


def launch_built_with(defines, a, b, *, tile_m=DEFAULT_TILE_M, fused=True,
                      counter=False):
    """The kernel on CUDA tensors a (n, M_l, K), b (K, N) through a build
    with ``-D`` ``defines`` (its tuning knobs: ``GA_PART_STAGES``, the
    stages summed in one partial; ``GA_GROUP_M``, the row tiles of a
    group), for ``chip_smoke.py``'s readings of the knobs against the
    production build."""
    if a.device.type != "cuda":
        raise ValueError(f"launch_built_with runs on cuda, not {a.device}")
    return _launch(a, b, tile_m=tile_m, fused=fused, counter=counter,
                   contexts=1, defines=tuple(defines))


def gemm_allgather(a_shards, b, mesh=None, *, axis="x",
                   tile_m=DEFAULT_TILE_M, fused=True, counter=False,
                   contexts=2, probe=None):
    """Global entry, the JAX package's layout: a_shards (n, M_l, K) (rank r's
    rows in row r), b (K, N) replicated. Returns (n, n*M_l, N): every rank
    holds the whole gathered product. ``mesh`` (a ``VirtualMesh``) is only
    checked: its rank count must be n. ``probe`` (a ``ScheduleProbe``)
    records rank 0's round program for ``probe.check(sched, contexts,
    counter)``: on CPU tensors :func:`record_rounds`, on CUDA tensors the
    probe build at one CTA a rank (:func:`record_card`, not counted in
    ``LAUNCHES``)."""
    del axis
    if mesh is not None and mesh.n != a_shards.shape[0]:
        raise ValueError(f"a mesh of {mesh.n} ranks cannot take "
                         f"{a_shards.shape[0]} shards")
    if a_shards.device.type == "cpu":
        out = gemm_allgather_plain(a_shards, b, tile_m=tile_m, fused=fused,
                                   counter=counter, contexts=contexts)
        if probe is not None:
            record_rounds(probe, make_broadcast_schedule(
                a_shards.shape[0], a_shards.shape[1], tile_m, fused),
                counter=counter, contexts=contexts)
        return out
    if a_shards.device.type != "cuda":
        raise ValueError(f"gemm_allgather runs on cuda or cpu, not "
                         f"{a_shards.device}")
    if probe is not None:
        return record_card(probe, a_shards, b, tile_m=tile_m, fused=fused,
                           counter=counter, contexts=contexts)
    return _launch(a_shards, b, tile_m=tile_m, fused=fused, counter=counter,
                   contexts=contexts)


# ------------------------------------------------------------ the op recorder


def record_rounds(probe, sched, *, counter=False, contexts=2):
    """Walk one rank's round program, as the reference's ``_ga_kernel``
    issues it, through ``core/schedule.py::SendWindow`` with its issue /
    retire hooks, recording on ``probe``: TILE_FUSED issues ``(off, t)``
    tile-major, COUNTER waits tile t - 1's arrivals while tile t's sends
    are in flight, then drains and waits the last tile's (SIGNAL: one
    wait an edge); DEFERRED issues one whole-slab round an offset, drains,
    then waits an edge each."""
    window.check_contexts(contexts)
    n = sched.n
    pending = []

    def start(entry):
        probe.issue(*pending.pop(0))

    def retire(entry):
        probe.wait_send()

    win = SendWindow(contexts, start=start, wait=retire)

    def issue(off, t):
        pending.append((off, t))
        win.push([(off, t)])

    if sched.fused:
        for t in range(sched.nt):
            for off in range(1, n):
                issue(off, t)
            if counter and t > 0:
                for _ in range(1, n):
                    probe.wait_recv()
        win.drain()
        for _ in range(1, n):
            probe.wait_recv()
    else:
        for off in range(1, n):
            issue(off, 0)
        win.drain()
        for _ in range(1, n):
            probe.wait_recv()
    return probe


def gemm_allgather_logged(a, b, *, tile_m=DEFAULT_TILE_M, fused=True,
                          counter=False, contexts=2, grid=None):
    """The probe build (``-DCUCO_PROBE``) on CUDA tensors: ``(out,
    events)``, ``events`` each CTA's decoded window log (CTA b is rank
    b % n). ``grid``: the full co-resident grid when None, else a multiple
    of n (n: one CTA a rank). Not counted in ``LAUNCHES``."""
    if a.device.type != "cuda":
        raise ValueError(f"the probe build is a kernel build; {a.device} "
                         "has none")
    out, log = _launch(a, b, tile_m=tile_m, fused=fused, counter=counter,
                       contexts=contexts, defines=window.PROBE_DEFINES,
                       grid=grid)
    return out, window.decode(log.events, log.counts)


def card_rounds(n, M_l, N, per_rank, pid, fused):
    """The rounds CTA ``pid`` of a rank pushes, in order: TILE_FUSED
    ``(off, u)`` for each tile u it owns (u = pid, pid + per_rank, ...,
    the rank's tiles in ``GA_GROUP_M`` groups, column by column inside a
    group) and offsets 1 .. n-1; DEFERRED ``(off, 0)``."""
    if not fused:
        return [(off, 0) for off in range(1, n)]
    M_p, _, N_p = padded(M_l, TILE_K, N)
    tiles = (M_p // TILE_M) * (N_p // TILE_N)
    return [(off, u) for u in range(pid, tiles, per_rank)
            for off in range(1, n)]


def check_log(events, *, n, M_l, N, contexts, tile_m=DEFAULT_TILE_M,
              fused=True, counter=False):
    """Hold a probe launch's log (any grid) to the window contract. The
    card's round is ``(off, u)``, a 128 x 128 tile u to peer off, where
    the schedule's round ``(off, t)`` is ``tile_m`` rows x all N columns:
    each CTA must push its tiles' rounds (:func:`card_rounds`) in that
    order and drain once; a rank's CTAs together push every tile's; their
    receive waits add up to ``completion_ticks(counter)`` (a COUNTER
    chunk is the schedule's tile)."""
    per_rank = len(events) // n
    sched = make_broadcast_schedule(n, M_l, tile_m, fused)
    stats = []
    for r in range(n):
        ctas = events[r::n]
        union = []
        for pid, evs in enumerate(ctas):
            where = f"gemm_allgather rank {r} CTA {pid}: "
            mine = card_rounds(n, M_l, N, per_rank, pid, fused)
            st = window.check_cta(evs, contexts, mine, where)
            if window.pushed(evs) != mine or st["drains"] != 1:
                raise window.WindowLogError(
                    f"{where}pushed {st['rounds']} rounds and {st['drains']} "
                    f"drains, not its {len(mine)} and 1")
            union += mine
            stats.append(st)
        window.check_rank(ctas, union, sched.completion_ticks(counter),
                          where=f"gemm_allgather rank {r}: ")
    return window.summary(stats)


def record_card(probe, a, b, *, tile_m=DEFAULT_TILE_M, fused=True,
                counter=False, contexts=2):
    """The probe build at one CTA a rank on CUDA tensors, rank 0's log
    recorded on ``probe`` as the reference's events (the card's round
    ``(off, u)`` kept as it is: tile u is the u-th 128 x 128 tile of the
    rank's walk). Where a tile is the schedule's round (N <= 128, tile_m
    128, M_l a multiple of 128; or DEFERRED) ``probe.check`` against
    ``make_broadcast_schedule`` holds; elsewhere a tile is a piece of a
    row of rounds and the issue order differs (ROADMAP §3). Returns the
    output."""
    out, events = gemm_allgather_logged(a, b, tile_m=tile_m, fused=fused,
                                        counter=counter, contexts=contexts,
                                        grid=a.shape[0])
    probe.events.extend(window.probe_events(events[0]))
    return out
