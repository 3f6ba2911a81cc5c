"""Fused device-initiated MoE dispatch/combine — the DeepEP analogue — as a
hand-written Hopper kernel (``repro_torch/csrc/moe_dispatch.cu``).

Port of ``repro/kernels/moe_dispatch.py``. One cooperative launch runs all
``n`` ranks as partitions of the card: each rank stages its tokens into
``block_tokens``-row microblocks per expert, stores them into the owning
expert's receive slab in the ``(off, j)`` rounds of
:class:`~repro_torch.core.schedule.DispatchSchedule` (dummy rounds always
elided), runs the expert SwiGLU FFN over the arrivals and stores the rows
back (combine). BARRIER, SIGNAL (pipelined) and COUNTER (tile-fused)
completions, the int8 wire and the shared-expert second stream are flags
of the one kernel; the source's header says how each is realized.
``counts`` is the routing: rows per expert, the same for every source
(the skew law's), or a table of rows per (source, expert) pair (a
router's), which :func:`pair_table` turns into the kernel's microblocks.

:func:`moe_dispatch_combine` launches the kernel for CUDA tensors and
raises when it cannot; for CPU tensors it computes
:func:`moe_dispatch_combine_ref`, the plain version the tests and
``chip_smoke.py`` hold the kernel against. ``contexts`` (1, 2 or 4, 2 as
in the reference) is the kernel's send window over its dispatch and
combine rounds (``csrc/window.cuh``). ``probe=`` (a ``ScheduleProbe``)
records the reference's marks: on CPU tensors :func:`record_marks`, on
CUDA tensors the probe build's (:func:`moe_dispatch_logged`,
:func:`check_log`). ``LAUNCHES`` counts kernel launches, keyed by variant
and shape (``CONTEXTS_LAUNCHED`` by ``contexts``); ``VARIANTS`` names the
knob sets the main path launches.
"""
from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass

import numpy as np

import torch
import torch.nn.functional as F

from repro_torch.core import telemetry
from repro_torch.kernels import build, window
from repro_torch.kernels.split import cta_split

# The schedule machinery is defined once, in repro_torch.core.schedule;
# re-exported here for the kernel's callers.
from repro_torch.core.schedule import (DispatchSchedule,  # noqa: F401
                                       SendWindow, make_schedule,
                                       sanitize_combine_tile)

MAX_RANKS = 8                 # MOE_MAXN in the CUDA source
TILE = 64                     # the kernel takes d, f and fs in multiples of it
TIMEOUT_MS = 20_000           # a spin-wait traps after this long
MAX_ROW_BYTES = 64 * 1024     # MOE_SLOT: a dispatched row stages whole

# (variant, n, T, d, f) -> kernel launches; read by chip_smoke.py
LAUNCHES = collections.Counter()
# contexts -> kernel launches: the directives' window reaches the card
CONTEXTS_LAUNCHED = collections.Counter()


def reset_launches():
    LAUNCHES.clear()
    CONTEXTS_LAUNCHED.clear()


def launches():
    """Kernel launches so far, all variants."""
    return sum(LAUNCHES.values())


# ------------------------------------------------------------ plain version


def quant_i8(x):
    """int8 wire quantization with per-row scales (the one copy of the
    formula; the XLA-style host build uses it too). ``torch.round`` rounds
    half to even, like ``jnp.round``."""
    s = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def swiglu_ffn(x, w1, w2):
    """The expert FFN: GEMM1 (2f, gate+up) -> SwiGLU -> GEMM2."""
    g, u = torch.chunk(x @ w1, 2, dim=-1)
    return (F.silu(g) * u) @ w2


def _offsets(counts):
    offs, acc = [], 0
    for c in counts:
        offs.append(acc)
        acc += int(c)
    return offs


@dataclass(frozen=True)
class PairTable:
    """The kernel's routing: source s sends ``counts[s][e]`` rows to
    expert e, the run of its rows from ``offsets(s)[e]``, in
    ``blocks[s][e]`` microblocks of ``block_tokens`` rows (padding rows
    included). ``packed``: the tile-fused kernel packs expert e's
    arrivals into one run (every source's rows back to back, sources in
    arrival order e, e + 1, ... mod n), so its GEMMs cover
    ceil(rows / block_tokens) microblocks, not the pairs' own."""
    n: int
    block_tokens: int
    counts: tuple          # (n, n) rows of each (source, expert) pair
    blocks: tuple          # (n, n) microblocks of each pair
    packed: bool = False

    @property
    def b_max(self):
        return max(max(r) for r in self.blocks)

    def offsets(self, s):
        return _offsets(self.counts[s])

    def rows(self, s):
        """Rows source s routes (the rest of its rows go nowhere)."""
        return sum(self.counts[s])

    def expert_rows(self, e):
        """Rows expert e's GEMMs cover: every source's microblocks, or
        packed, the microblocks of all its arrivals."""
        B = self.block_tokens
        if self.packed:
            return B * -(-sum(r[e] for r in self.counts) // B)
        return B * sum(r[e] for r in self.blocks)

    def packed_start(self, s, e):
        """Packed: the row of expert e's arrivals where source s's run
        starts."""
        return sum(self.counts[(e + i) % self.n][e]
                   for i in range((s - e) % self.n))


def pair_table(counts, block_tokens=64, tight=True, packed=False):
    """The :class:`PairTable` of ``counts``: rows per expert, every source
    alike (each row is :func:`make_schedule`'s counts and blocks), or an
    n x n table of rows per (source, expert) pair, each pair in
    ceil(rows / block_tokens) microblocks, or (not ``tight``) every pair
    in the largest pair's. ``packed`` (the tile-fused kernel's choice)
    packs a tight n x n table's arrivals; rows per expert keep the
    schedule's layout."""
    c = np.asarray(counts)
    if c.ndim == 1:
        sched = make_schedule(c, block_tokens, tight)
        return PairTable(sched.n, sched.block_tokens,
                         (sched.counts,) * sched.n,
                         (tuple(sched.blocks),) * sched.n)
    if c.ndim != 2 or c.shape[0] != c.shape[1] or (c < 0).any():
        raise ValueError(f"counts {c.tolist()} are neither rows per expert "
                         "nor an n x n table of rows per pair")
    rows = tuple(tuple(int(v) for v in r) for r in c)
    blocks = [[-(-v // block_tokens) for v in r] for r in rows]
    if not tight:
        most = max(max(r) for r in blocks)
        blocks = [[most] * len(r) for r in blocks]
    return PairTable(len(rows), block_tokens, rows,
                     tuple(tuple(r) for r in blocks), bool(packed and tight))


def _check_routes(table, x, counts):
    """Raise unless ``table`` routes the ranks of ``x`` (n, T, d): rows per
    expert route all T rows of each rank; a pair table at most T."""
    n, T = x.shape[0], x.shape[1]
    rows = [table.rows(s) for s in range(table.n)]
    if table.n != n or max(rows) > T or (np.ndim(counts) == 1
                                         and rows[0] != T):
        raise ValueError(f"counts {np.asarray(counts).tolist()} do not "
                         f"route x {tuple(x.shape)}")


def moe_dispatch_combine_ref(x, w1, w2, *, counts, block_tokens=64, tight=True,
                             wire_i8=False, shared=None, contexts=2):
    """Plain-torch version of the kernel on the stacked layout: x (n, T, d),
    w1 (n, d, 2f), w2 (n, f, d); rank r's rows ``[off_e, off_e+counts[e])``
    go to expert e (with a pair table, ``counts[r][e]`` rows from
    ``offsets(r)[e]``; the rows past a rank's last run come back zero).
    Each row crosses the wire alone (per-row int8 scales), so the
    microblock layout (``block_tokens``, ``tight``) changes where rows
    travel, never what comes back, and the send window (``contexts``,
    only checked) when. ``shared=(xs, s1, s2)`` adds the second stream and
    returns ``(y, ys)``."""
    window.check_contexts(contexts)
    table = pair_table(counts, block_tokens, tight)
    _check_routes(table, x, counts)

    def wire(rows):
        if not wire_i8:
            return rows
        q, s = quant_i8(rows)
        return q.to(torch.float32) * s

    y = torch.zeros_like(x)
    for r in range(table.n):
        for e, (off, c) in enumerate(zip(table.offsets(r), table.counts[r])):
            if c:
                y[r, off:off + c] = swiglu_ffn(wire(x[r, off:off + c]),
                                               w1[e], w2[e])
    if shared is None:
        return y
    xs, s1, s2 = shared
    return y, swiglu_ffn(xs, s1, s2)


# ------------------------------------------------------------ the kernel


class _Params(ctypes.Structure):
    """``MoeParams`` of ``csrc/moe_dispatch.cu``, field for field."""
    _fields_ = (
        [(k, ctypes.c_int) for k in ("n", "T", "Ts", "d", "f", "fs", "B",
                                     "b_max", "stride", "ct")]
        + [(k, ctypes.c_int * MAX_RANKS * MAX_RANKS)
           for k in ("counts", "blocks", "offsets")]
        + [("cta0", ctypes.c_int * (2 * MAX_RANKS + 1))]
        + [(k, ctypes.c_int) for k in ("barrier", "pipelined", "tile_fused",
                                       "shared", "wire_i8", "timeout_ms",
                                       "contexts", "log_cap", "packed")]
        + [(k, ctypes.c_void_p) for k in (
            "x", "w1", "w2", "xs", "s1", "s2", "y", "ys", "recv", "recv_s",
            "ffn_out", "comb", "h", "hs", "disp_flag", "comb_flag",
            "h_ready", "o_ready", "hs_ready")]
        + [("slot", window.LogOrStats), ("log_n", ctypes.c_void_p)])
    _anonymous_ = ("slot",)

# the kernel's CTA roles, in the order of its ``stats`` accumulator's rows
STAT_ROLES = ("routed", "second")


def load_kernel(probe=False, stats=False):
    """Build (if needed) and load the kernel without running it — the
    fast path's stage A and the cascade's l1. ``probe``: the build with
    ``-DCUCO_PROBE``, which logs its window (:func:`check_log`);
    ``stats``: the counting build (``build.STATS_DEFINES``), which one
    traced launch in 17 takes (``telemetry.kernel_counters``), built
    together with the production build so that a traced launch never
    waits for ``nvcc``; its failure does not fail the production build."""
    if probe:
        return build.load_typed("moe_dispatch", _Params, grid_args=3,
                                defines=window.PROBE_DEFINES)
    return build.load_typed("moe_dispatch", _Params, grid_args=3,
                            defines=build.STATS_DEFINES if stats else (),
                            together=((), build.STATS_DEFINES))


def grid_for(device, n, shared, wire_i8, probe=False, stats=False):
    """The co-resident grid the launch uses: CTAs per SM x SMs. Raises
    when it cannot give every rank one routed CTA (and one second-stream
    CTA with ``shared``). The production grid preloads the counting
    build's (:func:`build.preload`), so that a traced launch waits for no
    module load."""
    args = (int(n), int(shared), int(wire_i8))
    got = build.grid(load_kernel(probe, stats), device, *args)
    if not probe and not stats:
        build.preload("moe_dispatch", lambda: load_kernel(stats=True),
                      device, *args)
    return got


def tile_rows(left):
    """The token tile the kernel's core takes for an m-tile with ``left``
    rows from its start on: segments are cut into tiles of 128 rows, and a
    tile with at most 64 rows left takes 64 (``m64n64k8``), so a 64-row
    microblock is one 64-row tile (``tile_rows`` in the CUDA source)."""
    return 128 if left > 64 else 64


def segment_tiles(rows):
    """The token tiles (their widths, in order) of a segment of ``rows``
    rows."""
    return [tile_rows(rows - m0) for m0 in range(0, rows, 128)]


def _segments(sched, e, tile_fused):
    """Rows of each segment of expert e's routed GEMMs as the kernel cuts
    them: packed, each ``block_tokens``-row microblock of its arrivals;
    tile-fused, each microblock of each source; otherwise each source's
    microblocks together."""
    B = sched.block_tokens
    if sched.packed:
        return [B] * (sched.expert_rows(e) // B)
    if tile_fused:
        return [B] * sum(r[e] for r in sched.blocks)
    return [B * r[e] for r in sched.blocks]


def computed_rows(sched, e, tile_fused):
    """Token rows expert e's GEMM tiles cover: their widths summed over
    :func:`_segments` (a tile costs its width however many of its rows
    are tokens)."""
    return sum(sum(segment_tiles(r)) for r in _segments(sched, e, tile_fused))


def token_tiles(sched, f, d, *, tile_fused, shared=None):
    """``{128: tiles, 64: tiles}``: the GEMM units of one launch by token
    tile width, every rank's routed GEMM1 (``f / 64`` column slabs) and
    GEMM2 (``d / 128``), and with ``shared=(Ts, fs)`` every second
    stream's; the note the wrapper leaves on ``moe_dispatch.call``."""
    out = {128: 0, 64: 0}

    def add(rows, slabs):
        for w in segment_tiles(rows):
            out[w] += slabs
    per_row = f // 64 + -(-d // 128)
    for e in range(sched.n):
        for rows in _segments(sched, e, tile_fused):
            add(rows, per_row)
    if shared is not None:
        Ts, fs = shared
        for _ in range(sched.n):
            add(Ts, fs // 64 + -(-d // 128))
    return out


def rank_ctas(grid, sched, f, shared=None, tile_fused=False):
    """Each rank's ``(routed, second-stream)`` CTAs of a launch of
    ``grid`` CTAs: :func:`cta_split` by work. Rank e's routed stream runs
    the FFN (width ``f``) over the rows routed to its expert as the
    kernel computes them: every source's microblocks into e under the
    schedule or :class:`PairTable` ``sched``, cut into token tiles
    (:func:`computed_rows`: padding rows included, a GEMM tile costs its
    width however many of its rows are tokens; ``tile_fused`` cuts each
    microblock apart). With
    ``shared=(Ts, fs)`` its second stream runs the shared expert (width
    ``fs``) over its ``Ts`` rows (0 CTAs without). Every rank's second
    stream does the same work, so each takes the same CTAs: the whole
    CTAs of its share of the work (rounded down, at least one, and at
    least one left for each routed stream); the routed streams split the
    rest by their work. A second stream's time then depends on no rank's
    routing, and the routed streams, whose work does, take the spare
    CTAs."""
    n = sched.n
    if not isinstance(sched, PairTable):
        sched = pair_table(sched.counts, sched.block_tokens, sched.tight)
    routed = [computed_rows(sched, e, tile_fused) * f for e in range(n)]
    if shared is None:
        return [(c, 0) for c in cta_split(grid, routed)]
    second = sum(segment_tiles(shared[0])) * shared[1]
    each = max(1, min((grid - n) // n,
                      grid * second // (sum(routed) + n * second)))
    return [(c, each) for c in cta_split(grid - n * each, routed)]


def stream_starts(ctas):
    """The kernel's ``cta0`` prefix table from :func:`rank_ctas`: stream
    2r is rank r's routed stream, 2r + 1 its second stream."""
    starts = [0]
    for routed, second in ctas:
        starts += [starts[-1] + routed, starts[-1] + routed + second]
    return starts


# Knobs of each variant the main path launches, as
# MoEDispatch.kernel_knobs resolves its directives (block_tokens 64, tight
# wire); the shared-expert stream comes with the workload, not the knobs.
VARIANTS = {
    "barrier": dict(barrier=True, pipelined=False),
    "deferred_signal": dict(pipelined=False),
    "pipelined_signal": dict(pipelined=True),
    "tile_fused": dict(tile_fused=True),
    "tile_fused+int8": dict(tile_fused=True, wire_i8=True),
    "tile_fused_ct16": dict(tile_fused=True, combine_tile=16),
}


def variant_name(*, barrier, pipelined, tile_fused, wire_i8, shared,
                 combine_tile, block_tokens):
    if tile_fused:
        name = "tile_fused"
        if sanitize_combine_tile(combine_tile, block_tokens) != block_tokens:
            name += f"_ct{sanitize_combine_tile(combine_tile, block_tokens)}"
    elif barrier:
        name = "barrier"
    else:
        name = "pipelined_signal" if pipelined else "deferred_signal"
    if shared:
        name += "+shared"
    if wire_i8:
        name += "+int8"
    return name


def _launch(x, w1, w2, counts, block_tokens, tight, *, barrier, pipelined,
            tile_fused, wire_i8, combine_tile, shared, contexts, pad=True,
            probe=False):
    """One launch on ``x``'s card, in three spans: ``moe_dispatch.prepare``
    (the schedule, the padding to tiles, the checks, the grid and its CTA
    split, the ``_Params`` pack), ``moe_dispatch.alloc`` (the scratch, the
    flags' zero fill) and ``moe_dispatch.launch``. ``pad``: pad d, f and
    fs to the tile (:func:`pad_to_tiles`); otherwise raise on widths that
    are not multiples of it. Returns the output, or with ``probe`` (the
    ``-DCUCO_PROBE`` build, uncounted) ``(out, log, stream starts)``."""
    with telemetry.span("moe_dispatch.prepare"):
        window.check_contexts(contexts)
        sched = pair_table(counts, block_tokens, tight, packed=tile_fused)
        _check_routes(sched, x, counts)
        d0 = x.shape[2]
        if pad:
            x, w1, w2, shared = pad_to_tiles(x, w1, w2, shared)
        n, T, d = x.shape
        f = w2.shape[1]
        B = sched.block_tokens
        tensors = [x, w1, w2] + (list(shared) if shared is not None else [])
        for t in tensors:
            if t.device != x.device or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError("moe_dispatch wants contiguous float32 "
                                 f"tensors on {x.device}; got {t.dtype} on "
                                 f"{t.device}")
        if not 1 <= n <= MAX_RANKS:
            raise ValueError(f"moe_dispatch runs 1..{MAX_RANKS} ranks, "
                             f"got {n}")
        if w1.shape != (n, d, 2 * f) or w2.shape != (n, f, d):
            raise ValueError(f"expert weights {tuple(w1.shape)}, "
                             f"{tuple(w2.shape)} do not match x "
                             f"{tuple(x.shape)}")
        if shared is not None:
            xs, s1, s2 = shared
            Ts, fs = xs.shape[1], s2.shape[0]
            if xs.shape != (n, Ts, d) or s1.shape != (d, 2 * fs) \
                    or s2.shape != (fs, d):
                raise ValueError("shared-expert operands do not match x")
        else:
            Ts, fs = 0, TILE
        if d % TILE or f % TILE or fs % TILE:
            raise ValueError(f"d={d}, f={f}, fs={fs} must be multiples of "
                             f"{TILE}")
        if 4 * d > MAX_ROW_BYTES:
            raise ValueError(f"a row of d={d} floats does not fit the "
                             f"kernel's {MAX_ROW_BYTES}-byte send slot")
        dev = x.device
        # while a profiler records: the counting build and its counters
        stats = None if probe else telemetry.kernel_counters(
            "moe_kernel", STAT_ROLES, dev)
        grid, _ = grid_for(dev, n, shared is not None, wire_i8, probe,
                           stats is not None)
        second = None if shared is None else (Ts, fs)
        ctas = rank_ctas(grid, sched, f, second, tile_fused)
        tiles = token_tiles(sched, f, d, tile_fused=tile_fused, shared=second)
        telemetry.note("moe_dispatch.tiles_128", tiles[128])
        telemetry.note("moe_dispatch.tiles_64", tiles[64])
        stride = sched.b_max * B
        slab = n * stride
        p = _Params(n=n, T=T, Ts=Ts, d=d, f=f, fs=fs, B=B, b_max=sched.b_max,
                    stride=stride, ct=sanitize_combine_tile(combine_tile, B),
                    barrier=int(barrier), pipelined=int(pipelined),
                    tile_fused=int(tile_fused), shared=int(shared is not None),
                    wire_i8=int(wire_i8), timeout_ms=TIMEOUT_MS,
                    contexts=int(contexts), packed=int(sched.packed),
                    stats=None if stats is None else stats.data_ptr())
        for s in range(n):
            p.counts[s][:n] = sched.counts[s]
            p.blocks[s][:n] = sched.blocks[s]
            p.offsets[s][:n] = sched.offsets(s)
        p.cta0[:2 * n + 1] = stream_starts(ctas)
    with telemetry.span("moe_dispatch.alloc"):
        wire_dt = torch.int8 if wire_i8 else torch.float32
        ptr = lambda t: t.data_ptr()  # noqa: E731
        # held until the launch is enqueued: a freed block would be handed
        # to the next allocation here
        recv = torch.empty((n, slab, d), dtype=wire_dt, device=dev)
        scratch = [torch.empty((n, slab), dtype=torch.float32, device=dev)]
        scratch += [torch.empty((n, slab, w), dtype=torch.float32, device=dev)
                    for w in (d, d, f)]
        p.recv = ptr(recv)
        p.recv_s, p.ffn_out, p.comb, p.h = map(ptr, scratch)
        y = torch.empty_like(x)
        p.x, p.w1, p.w2, p.y = ptr(x), ptr(w1), ptr(w2), ptr(y)
        if shared is not None:
            ys = torch.empty((n, Ts, d), dtype=torch.float32, device=dev)
            hs = torch.empty((n, Ts, fs), dtype=torch.float32, device=dev)
            p.xs, p.s1, p.s2, p.ys, p.hs = (ptr(xs), ptr(s1), ptr(s2),
                                            ptr(ys), ptr(hs))
        # flags and the "H ready" / "out ready" counters, zeroed on the
        # launch stream: dispatch (n, n, b_max), combine (n, n), H ready
        # (n, n, b_max), out ready (n, n), second-stream H ready (n)
        n_disp = n * n * sched.b_max
        flags = torch.zeros(2 * n_disp + 2 * n * n + n, dtype=torch.int32,
                            device=dev)
        base = flags.data_ptr()
        p.disp_flag = base
        p.comb_flag = base + 4 * n_disp
        p.h_ready = base + 4 * (n_disp + n * n)
        p.o_ready = base + 4 * (2 * n_disp + n * n)
        p.hs_ready = base + 4 * (2 * n_disp + 2 * n * n)
        # the probe build logs its window; the production build writes no
        # log and keeps null log pointers
        if probe:
            log = window.DeviceLog.alloc(grid, log_cap(sched, d), dev)
            for k, v in log.params().items():
                setattr(p, k, v)
    with telemetry.span("moe_dispatch.launch"):
        build.launch(load_kernel(probe, stats is not None), p, dev, grid)
    out = (y, ys) if shared is not None else y
    if d != d0:
        out = tuple(o[..., :d0] for o in out) if shared is not None \
            else out[..., :d0]
    if probe:   # not a launch of the counted paths
        return out, log, stream_starts(ctas)
    CONTEXTS_LAUNCHED[int(contexts)] += 1
    LAUNCHES[(variant_name(barrier=barrier, pipelined=pipelined,
                           tile_fused=tile_fused, wire_i8=wire_i8,
                           shared=shared is not None,
                           combine_tile=combine_tile, block_tokens=B),
              n, T, d, f)] += 1
    # the scratch is freed here; the caching allocator reuses it only in
    # this stream's order, after the launch
    return out


def moe_dispatch_combine(x, w1, w2, *, counts, block_tokens=64, tight=True,
                         pipelined=True, barrier=False, wire_i8=False,
                         tile_fused=False, combine_tile=None, shared=None,
                         contexts=2, probe=None):
    """Global entry, the JAX package's layout: x (n, T, d) with each rank's
    rows sorted into contiguous per-expert blocks by ``counts`` (rows per
    expert, or an n x n table of rows per (source, expert) pair:
    :func:`pair_table`); w1
    (n, d, 2f), w2 (n, f, d) — expert e's weights on rank e. Returns
    (n, T, d), or ``(y, ys)`` with ``shared=(xs, s1, s2)`` — xs (n, Ts, d),
    s1 (d, 2fs), s2 (fs, d) replicated.

    The ranks are the leading axis of ``x`` (no mesh argument).
    ``contexts`` (1, 2 or 4) is the send window's depth. ``probe`` (a
    ``ScheduleProbe``) records rank 0's marks: on CPU tensors the
    reference's order (:func:`record_marks`), on CUDA tensors the probe
    build's, in the order of their times (:func:`record_card`). CUDA
    tensors launch the kernel (or raise); CPU tensors compute the plain
    version."""
    if tile_fused and barrier:
        raise ValueError("tile_fused (COUNTER completion) excludes a "
                         "BARRIER rendezvous")
    if x.device.type == "cpu":
        out = moe_dispatch_combine_ref(x, w1, w2, counts=counts,
                                       block_tokens=block_tokens,
                                       tight=tight, wire_i8=wire_i8,
                                       shared=shared, contexts=contexts)
        if probe is not None:
            record_marks(probe, make_schedule(counts, block_tokens, tight),
                         contexts=contexts, shared=shared is not None)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"moe_dispatch runs on cuda or cpu, not {x.device}")
    knobs = dict(barrier=barrier, pipelined=pipelined, tile_fused=tile_fused,
                 wire_i8=wire_i8, combine_tile=combine_tile, shared=shared,
                 contexts=contexts)
    with telemetry.span("moe_dispatch.call"):
        if probe is None:
            return _launch(x, w1, w2, counts, block_tokens, tight, **knobs)
        out, log, starts = _launch(x, w1, w2, counts, block_tokens, tight,
                                   probe=True, **knobs)
        record_card(probe, window.decode(log.events, log.counts), starts)
        return out


def _pad_last(t, n):
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def _pad_swiglu(w, d, f):
    """(..., d0, 2 f0) gate | up weights -> (..., d, 2 f), each half
    padded apart."""
    g, u = torch.chunk(w, 2, dim=-1)
    w = torch.cat([_pad_last(g, f), _pad_last(u, f)], dim=-1)
    return _pad_last(w.transpose(-1, -2), d).transpose(-1, -2).contiguous()


def pad_to_tiles(x, w1, w2, shared=None):
    """The operands with d, f and fs padded with zeros to multiples of
    ``TILE`` (the tile GEMM's), where they are not: a zero column of x and
    zero rows and columns of the weights add exact zeros to every real
    sum, and a padded hidden unit is silu(0) * 0 = 0, so the first d
    columns of the output are the unpadded call's (the int8 wire's row
    scales, a row's max, are unchanged too). Returns ``(x, w1, w2,
    shared)``, the inputs themselves where nothing needs padding."""
    d0, f0 = x.shape[2], w2.shape[1]
    fs0 = shared[2].shape[0] if shared is not None else TILE
    up = lambda v: -(-v // TILE) * TILE  # noqa: E731
    d, f, fs = up(d0), up(f0), up(fs0)
    if (d, f, fs) == (d0, f0, fs0):
        return x, w1, w2, shared
    x = _pad_last(x, d).contiguous()
    w1 = _pad_swiglu(w1, d, f)
    w2 = _pad_last(F.pad(w2, (0, 0, 0, f - f0)), d).contiguous()
    if shared is not None:
        xs, s1, s2 = shared
        shared = (_pad_last(xs, d).contiguous(), _pad_swiglu(s1, d, fs),
                  _pad_last(F.pad(s2, (0, 0, 0, fs - fs0)), d).contiguous())
    return x, w1, w2, shared


# ------------------------------------------------------------ the op recorder


def log_cap(sched, d):
    """Events one routed CTA logs at most: a push and a retire a
    dispatch round (every round of its rank at worst) and a combine round
    (every GEMM2 tile of its rank's, at worst), two drains, two marks, and
    room to spare. Packed, a pair's run may take one round more than its
    microblocks, and a tile one round a source it holds."""
    rounds = sched.n * (sched.b_max + int(sched.packed))
    tiles = -(-d // 128) * len(segment_tiles(sched.block_tokens))
    return 2 * rounds * (1 + tiles) + 16


def record_marks(probe, sched, *, contexts=2, shared=False):
    """The reference's dispatch window with its marks on ``probe``: every
    round ``(off, j)`` pushed through ``core/schedule.py::SendWindow``,
    ``dispatch_issued``, the second stream's ``shared_ffn`` in the overlap
    slot (with ``shared``), the drain, ``dispatch_drained``."""
    win = SendWindow(window.check_contexts(contexts), start=lambda e: None,
                     wait=lambda e: None)
    for rnd in sched.rounds:
        win.push(rnd)
    probe.mark("dispatch_issued")
    if shared:
        probe.mark("shared_ffn")
    win.drain()
    probe.mark("dispatch_drained")
    return probe


def _time_order(base):
    """A sort key for 32-bit ns stamps near ``base`` (wrap-safe)."""
    return lambda t: ((t - base + 2**31) % 2**32) - 2**31


def record_card(probe, events, starts):
    """Rank 0's marks of a probe launch on ``probe``, in the order of
    their times: the last routed CTA's ``dispatch_issued`` and
    ``dispatch_drained`` and the second stream's first ``shared_ffn``. The
    card runs the second stream on CTAs of its own from the launch on, so
    ``shared_ffn`` may come before ``dispatch_issued``; what the
    reference's order asserts, the shared FFN running while dispatch sends
    are in flight, is :func:`check_log`'s check that its span opens before
    ``dispatch_drained``."""
    marks = _rank_marks(events, starts, 0)
    order = sorted(marks.items(), key=lambda kv: _time_order(
        marks["dispatch_issued"])(kv[1]))
    for name, _ in order:
        probe.mark(name)
    return probe


def _rank_marks(events, starts, r):
    routed = events[starts[2 * r]:starts[2 * r + 1]]
    second = events[starts[2 * r + 1]:starts[2 * r + 2]]
    def times(ctas, name):
        return [ev[2] for evs in ctas for ev in evs
                if ev[0] == "mark" and ev[1] == name]
    issued, drained = times(routed, "dispatch_issued"), times(
        routed, "dispatch_drained")
    if len(issued) != len(routed) or len(drained) != len(routed):
        raise window.WindowLogError(f"moe rank {r}: {len(issued)} / "
                                    f"{len(drained)} dispatch marks from "
                                    f"{len(routed)} routed CTAs")
    key = _time_order(issued[0])
    marks = {"dispatch_issued": max(issued, key=key),
             "dispatch_drained": max(drained, key=key)}
    shared = times(second, "shared_ffn")
    if second:
        if len(shared) != len(second):
            raise window.WindowLogError(f"moe rank {r}: {len(shared)} "
                                        "shared_ffn marks from "
                                        f"{len(second)} second-stream CTAs")
        marks["shared_ffn"] = min(shared, key=key)
    return marks


def moe_dispatch_logged(x, w1, w2, *, counts, block_tokens=64, tight=True,
                        contexts=2, **knobs):
    """The probe build (``-DCUCO_PROBE``) on CUDA tensors at the full
    grid: ``(out, events, starts)``, ``events`` each CTA's decoded window
    log and ``starts`` the streams' CTA table (stream 2r: rank r's routed
    CTAs, 2r + 1 its second stream). Takes :func:`moe_dispatch_combine`'s
    knobs; not counted in ``LAUNCHES``."""
    if x.device.type != "cuda":
        raise ValueError(f"the probe build is a kernel build; {x.device} "
                         "has none")
    knobs = dict(dict(barrier=False, pipelined=True, tile_fused=False,
                      wire_i8=False, combine_tile=None, shared=None), **knobs)
    out, log, starts = _launch(x, w1, w2, counts, block_tokens, tight,
                               contexts=contexts, pad=False, probe=True,
                               **knobs)
    return out, window.decode(log.events, log.counts), starts


def combine_rounds(sched, me, d, tile_fused):
    """Rank ``me``'s combine rounds in order: non-fused ``(off, j)`` for
    its expert's ``blocks[me]`` microblocks to each source; tile-fused
    ``(off, tile)`` a GEMM2 tile (:func:`segment_tiles` of a microblock x
    128 columns) of each microblock, tile = (j * column tiles + column) *
    m-tiles + m-tile."""
    n, B, mb = sched.n, sched.block_tokens, sched.blocks[me]
    if not tile_fused:
        return [(off, j) for off in range(n) for j in range(mb)]
    ct, mt = -(-d // 128), len(segment_tiles(B))
    return [(off, (j * ct + c) * mt + m) for off in range(n)
            for j in range(mb) for c in range(ct) for m in range(mt)]


def check_log(events, starts, sched, *, d, contexts, tile_fused=False,
              shared=False, **_):
    """Hold a probe launch's log to the window contract: each routed CTA
    of rank me pushes its share of dispatch rounds ``(off, j)`` in the
    schedule's order (dummy rounds elided), drains (marks
    ``dispatch_issued`` / ``dispatch_drained`` around it), then pushes
    its combine rounds (:func:`combine_rounds`) in order and drains again;
    the rank's CTAs together push every real dispatch round and every
    combine round; and the second stream's first ``shared_ffn`` comes
    before the last ``dispatch_drained``. DispatchSchedule has no
    ``completion_ticks``, so no receive count is held (as the reference's
    ``ScheduleProbe.check`` skips it)."""
    n = sched.n
    stats = []
    for me in range(n):
        disp = [(off, j) for off, j in sched.rounds
                if j < sched.blocks[(me - off) % n]]
        comb = combine_rounds(sched, me, d, tile_fused)
        routed = events[starts[2 * me]:starts[2 * me + 1]]
        got_d, got_c = [], []
        for i, evs in enumerate(routed):
            where = f"moe rank {me} CTA {i}: "
            st = window.check_cta(evs, contexts, where=where)
            if st["drains"] != 2:
                raise window.WindowLogError(f"{where}{st['drains']} drains, "
                                            "not 2")
            cut = next(k for k, ev in enumerate(evs) if ev[0] == "drain")
            first, second = window.pushed(evs[:cut]), window.pushed(evs[cut:])
            window.check_order(first, disp, where + "dispatch: ")
            window.check_order(second, comb, where + "combine: ")
            got_d += first
            got_c += second
            stats.append(st)
        for got, want, what in ((got_d, disp, "dispatch"),
                                (got_c, comb, "combine")):
            window.check_rank([[("issue", *r) for r in got]], want,
                              where=f"moe rank {me} {what}: ")
        marks = _rank_marks(events, starts, me)
        if shared:
            key = _time_order(marks["dispatch_issued"])
            if not key(marks["shared_ffn"]) < key(marks["dispatch_drained"]):
                raise window.WindowLogError(
                    f"moe rank {me}: the shared FFN opened after the "
                    "dispatch window drained")
    return window.summary(stats)

# ------------------------------------------------------- the tile GEMM alone


def gemm_core_plain(a, b, *, swiglu=False):
    """Plain version of :func:`gemm_core`."""
    if swiglu:
        g, u = torch.chunk(a @ b, 2, dim=-1)
        return F.silu(g) * u
    return a @ b


def gemm_core(a, b, *, swiglu=False):
    """The moe kernel's tile core alone (``moe_dispatch_gemm`` of the
    moe_dispatch library): ``csrc/wg_tile.cuh``'s 3xTF32 ``wgmma`` core,
    one CTA an SM over tiles of 128 (or, for a last tile of at most 64
    rows, 64) rows x 128 columns, where K and N are multiples of 4 and the
    bases 16-byte aligned; else ``csrc/tc_gemm.cuh``'s 64 x 128 tile.
    ``workloads/scmoe.py``'s router and FFN2 on the main path, and
    ``chip_smoke.py``'s ``gemm_core`` line. a (M, K) @ b (K, N)
    float32; ``swiglu``: silu(a b[:, :N/2]) * (a b[:, N/2:]), N/2 a
    multiple of 64. CUDA tensors launch the kernel (or raise); CPU tensors
    compute :func:`gemm_core_plain`."""
    if a.device.type == "cpu":
        return gemm_core_plain(a, b, swiglu=swiglu)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] \
            or a.shape[0] < 1:
        raise ValueError(f"gemm_core wants a (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    for t in (a, b):
        if t.device != a.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("gemm_core wants contiguous float32 tensors on "
                             f"{a.device}; got {t.dtype} on {t.device}")
    (M, K), N = a.shape, b.shape[1]
    if swiglu and N % (2 * TILE):
        raise ValueError(f"gemm_core's SwiGLU wants N/2 a multiple of {TILE}, "
                         f"got N={N}")
    out = torch.empty((M, N // 2 if swiglu else N), device=a.device)
    vec = K % 4 == 0 and N % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (a, b, out))
    if swiglu and not vec:
        raise ValueError("gemm_core's SwiGLU wants 16-byte aligned operands")
    lib = load_kernel()
    fn = lib.moe_dispatch_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with torch.cuda.device(a.device):
        build._check(lib, fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M,
                             K, N, int(swiglu), int(vec),
                             torch.cuda.current_stream(a.device).cuda_stream),
                     "gemm_core launch")
    return out
