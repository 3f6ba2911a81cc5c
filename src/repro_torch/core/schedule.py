"""The collective-schedule contract — the single definition site for the
trace-time schedule machinery every device-initiated kernel builds against
(and the slow-path search refines against).

The paper's central claim is that a *structured design-space formalization*
lets an agent co-design compute and communication across many workloads.
This module is where that structure lives on the kernel side: a
:class:`CollectiveSchedule` is a trace-time total order of **rounds** —
``(edge, tile)`` events — that is identical on every rank, plus the wire /
round / tick accounting the l3 cost model charges. Three concrete builders
cover the realization matrix:

  * :class:`DispatchSchedule` — moe_dispatch permutation rounds ``(off, j)``
    over variable-size per-peer microblocks (dummy-padded for lockstep).
  * :class:`BroadcastSchedule` — gemm_allgather shift-broadcast rounds
    ``(off, t)`` (dense: nothing to pad or elide).
  * :class:`RingSchedule` — ring-rotation rounds ``(step, chunk)`` for the
    ring workloads (ring_attention KV rotation, kv_shuttle K→V tiles).

**The contract** (enforced at runtime by the legacy 0.4.x pallas
interpreter's lockstep discharge, property-tested in
``tests/test_schedules.py``):

1. ``rounds`` is a total, deterministic, rank-independent order; every
   ``(edge, tile)`` event appears exactly once. Every rank issues every
   round's DMA **unconditionally** (no role-predicated ``pl.when`` around
   ``dma.start()``) and each round's edges form a permutation.
2. ``send_window_depths(contexts)`` mirrors the kernels' bounded-issue
   algorithm: at most ``contexts`` rounds' send semaphores stay unawaited;
   the oldest is ``wait_send``-ed before the next round issues.
3. ``issued_rounds()`` / ``completion_ticks()`` are the DMA-issue and
   receive-readiness counts the cost model charges ``TILE_SYNC`` per event.
4. Receive-semaphore slots follow the :func:`sem_slot` convention — slot
   ``s`` counts arrivals from source ``s`` under either semaphore engine.
5. Numeric knobs drawn from ``design_space.TUNABLES`` need not divide a
   given shape: consumers repair them with :func:`sanitize_tile` (largest
   divisor) at their own boundary so a slow-path diff patch can never
   crash the evaluator.

This module is pure trace-time Python (no jax imports at module scope) so
the schedules stay property-testable without a device backend.

Port copy of ``repro/core/schedule.py``, held against it by
``tests/test_torch_core.py``; only :func:`sem_slot` differs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "CollectiveSchedule", "DispatchSchedule", "BroadcastSchedule",
    "RingSchedule", "SendWindow", "make_schedule",
    "make_broadcast_schedule", "make_ring_schedule", "block_counts",
    "send_window_depths", "sanitize_tile", "sanitize_combine_tile",
    "sanitize_tile_m", "sanitize_kv_chunk", "sem_slot", "check_live",
    "respill_counts",
]


# ------------------------------------------------------------ shared pieces


def send_window_depths(rounds, contexts):
    """In-flight send depth after each issued round under a ``contexts``-
    deep window — the kernels' issue algorithm (wait_send the oldest
    in-flight round before issuing past the cap) mirrored at trace time.
    Shared by every :class:`CollectiveSchedule` and property-tested in
    tests/test_schedules.py."""
    cap = max(1, int(contexts))
    depth, out = 0, []
    for _ in rounds:
        if depth >= cap:
            depth -= 1
        depth += 1
        out.append(depth)
    return out


class SendWindow:
    """The kernels' bounded-issue algorithm — the executable counterpart of
    :func:`send_window_depths` (one code path for all four kernels, so the
    property-tested trace-time mirror and the issued DMAs cannot drift).

    At most ``contexts`` *rounds'* send semaphores stay unawaited; the
    oldest round is waited before the next one issues. A round may span
    several DMA descriptors (a K/V chunk pair, a data+scale pair): they
    count as ONE window entry — :meth:`push` opens a round and
    :meth:`amend` adds a descriptor issued later in the same round.

    ``start``/``wait`` hooks customize how an entry's descriptors are
    started and retired (moe_dispatch predicates both under the same
    ``pl.when`` for dummy elision); the defaults start every descriptor
    and ``wait_send`` each on retirement.
    """

    def __init__(self, contexts, *, start=None, wait=None):
        self.cap = max(1, int(contexts))
        self._rounds = []
        self._start = start or (lambda cps: [cp.start() for cp in cps])
        self._wait = wait or (lambda cps: [cp.wait_send() for cp in cps])

    def push(self, entry):
        """Open a new round: retire the oldest past the cap, then start.
        ``entry`` is a list of descriptors (mutable, so :meth:`amend` can
        extend it) — or any opaque value when custom hooks are given."""
        if len(self._rounds) >= self.cap:
            self._wait(self._rounds.pop(0))
        self._start(entry)
        self._rounds.append(entry)

    def amend(self, cp):
        """Start a descriptor belonging to the most recent round (e.g. the
        V half of a K/V pair issued after the V tile's GEMM)."""
        cp.start()
        self._rounds[-1].append(cp)

    def drain(self):
        """Retire every in-flight round (step/kernel boundary)."""
        while self._rounds:
            self._wait(self._rounds.pop(0))


def check_live(live_ranks, n):
    """Validate a degraded-membership set against an ``n``-rank schedule.

    Returns the canonical live tuple (sorted, deduplicated). Raises
    ``ValueError`` on an empty set or an out-of-range rank — the one
    contract every ``degrade(live_ranks)`` implementation shares, so a
    malformed membership update fails loudly at trace time instead of
    wedging a kernel at run time."""
    live = tuple(sorted({int(r) for r in live_ranks}))
    if not live:
        raise ValueError("degrade: live_ranks must be non-empty "
                         "(a collective needs at least one survivor)")
    if live[0] < 0 or live[-1] >= n:
        raise ValueError(
            f"degrade: live_ranks {live} out of range for n={n}")
    return live


def respill_counts(counts, live_ranks, capacity_factor=1.25):
    """Capacity-factor re-spill: re-route the tokens of dead experts onto
    the survivors. Token-conserving (``sum`` is preserved) and
    deterministic: spilled tokens fill the survivor with the most headroom
    below ``capacity_factor * total / len(live)`` first (ties break toward
    the lower live index); once every survivor is at capacity the overflow
    spreads uniformly. The result is the ``counts`` of the degraded
    :class:`DispatchSchedule` — a smaller instance of the same class."""
    counts = tuple(int(c) for c in counts)
    live = check_live(live_ranks, len(counts))
    total = int(sum(counts))
    new = [counts[e] for e in live]
    spilled = total - sum(new)
    if spilled > 0:
        cap = max(1, int(math.ceil(capacity_factor * total / len(live))))
        while spilled:
            i = max(range(len(new)), key=lambda j: (cap - new[j], -j))
            if cap - new[i] <= 0:
                break                    # every survivor at capacity
            give = min(spilled, cap - new[i])
            new[i] += give
            spilled -= give
        if spilled:                      # overflow beyond the factor
            q, r = divmod(spilled, len(new))
            new = [c + q + (1 if i < r else 0) for i, c in enumerate(new)]
    return tuple(new)


def sanitize_tile(tile, total):
    """Largest divisor of ``total`` that is <= the requested ``tile``.

    One sanitizer algorithm for the whole package: slow-path diff patches
    draw tile knobs from the central ``TUNABLES`` grids, which need not
    divide a given workload shape — the kernel contract requires an exact
    divisor. ``None``/0 means "the whole extent" (one tile)."""
    total = int(total)
    t = int(tile) if tile else total
    t = max(1, min(t, total))
    while total % t:
        t -= 1
    return t


# per-knob aliases: each names the shape it divides (docs/kernels.md)
def sanitize_combine_tile(combine_tile, block_tokens):
    """moe_dispatch fused-combine GEMM tile rows -> divisor of the
    ``block_tokens`` microblock."""
    return sanitize_tile(combine_tile, block_tokens)


def sanitize_tile_m(tile_m, M_l):
    """gemm_allgather GEMM tile rows -> divisor of the local slab."""
    return sanitize_tile(tile_m, M_l)


def sanitize_kv_chunk(kv_chunk, rows):
    """ring rotation chunk rows -> divisor of the local KV shard."""
    return sanitize_tile(kv_chunk, rows)


def sem_slot(me, inbound_src):
    """Receive-semaphore slot for an arrival from ``inbound_src``.

    The convention is **slot s = edge from source rank s**. Under faithful
    sender-driven RDMA (hardware, or the modern ``InterpretParams``
    simulator) the *sender's* descriptor names the slot its signal lands in
    on the receiver — the issuer's own rank (``me``). The legacy lockstep
    discharge instead increments the slot named by the *receiver's* own
    descriptor — its inbound peer for this round (``inbound_src``). Both
    reduce to the same convention once routed through here; kernels with
    per-edge semaphore arrays must use this (single-edge kernels like the
    ring, whose receive semaphores are scalar per chunk slot, need not).

    The Hopper kernels replace each semaphore with a flag word that the
    sender bumps, so only the sender-driven slot exists here."""
    del inbound_src
    return me


class CollectiveSchedule:
    """Base contract: a trace-time lockstep round order plus accounting.

    Concrete schedules are frozen dataclasses exposing ``rounds`` (the
    total order of ``(edge, tile)`` events), ``rows_per_round``, and the
    issue/tick counts below; kernels iterate ``rounds`` to issue DMAs and
    the l3 cost model charges the same counts."""

    @property
    def rounds(self):
        raise NotImplementedError

    def issued_rounds(self):
        """``dma_start`` rounds each rank issues (default: every round)."""
        return len(self.rounds)

    def send_window_depths(self, contexts):
        """See module-level :func:`send_window_depths`."""
        return send_window_depths(self.rounds, contexts)

    def degrade(self, live_ranks):
        """Membership-aware degraded-mode schedule over ``live_ranks``.

        Returns a **smaller instance of the same class** under compaction
        renumbering (live rank ``r`` becomes its index in the sorted live
        tuple): rounds name shift *offsets*, never absolute ranks, so the
        compacted schedule trivially re-satisfies the whole contract —
        lockstep total order, edges-exactly-once-among-live-ranks, the
        ``contexts`` window cap — and the kernels run it unmodified on the
        surviving mesh. No round ever names a dead rank, so no DMA is
        issued to (and no semaphore wait taken on) one: bounded-wait by
        construction. ``degrade`` with every rank live returns ``self``."""
        raise NotImplementedError


# ------------------------------------------------- moe_dispatch (the flagship)


def block_counts(counts, block_tokens, tight=True):
    """Microblocks per edge into each expert. Padded mode ships the
    max-capacity block count on every edge (the XLA all-to-all shape)."""
    b = [int(math.ceil(c / block_tokens)) for c in counts]
    if not tight:
        b = [max(b)] * len(b)
    return b


@dataclass(frozen=True)
class DispatchSchedule(CollectiveSchedule):
    """Trace-time routing schedule + its wire accounting (tokens, per rank).

    ``rounds`` is the lockstep permutation-round list ``[(off, j), ...]``:
    in round ``(off, j)`` rank ``r`` exchanges microblock ``j`` with peer
    ``(r - off) % n`` (dispatch) / ``(r + off) % n`` (combine). Ranks whose
    edge has fewer than ``j + 1`` real blocks ship a dummy block into the
    receiver's trash row to keep the permutation total; real hardware
    elides them (``elide_dummy``).
    """
    n: int
    block_tokens: int
    counts: tuple          # exact tokens routed to each expert (per rank)
    blocks: tuple          # microblocks per edge into each expert
    tight: bool

    @property
    def b_max(self):
        return max(self.blocks)

    @property
    def rounds(self):
        return [(off, j) for off in range(self.n)
                for j in range(self.b_max)]

    def wire_tokens(self, rank=0):
        """Exact off-rank tokens rank ``rank`` dispatches (the l3 credit):
        tight = sum(counts) - counts[rank]; padded = C * (n - 1)."""
        if self.tight:
            return int(sum(self.counts)) - int(self.counts[rank])
        return int(max(self.counts)) * (self.n - 1)

    def executed_wire_tokens(self, rank=0):
        """Block-rounded off-rank tokens the kernel actually ships for rank
        ``rank`` (real microblocks only, dummies excluded)."""
        return sum(self.blocks[e] * self.block_tokens
                   for e in range(self.n) if e != rank)

    def dummy_wire_tokens(self, rank=0):
        """Off-rank dummy (trash-row) tokens the lockstep interpreter path
        additionally ships for rank ``rank``; elided on real hardware."""
        return sum((self.b_max - self.blocks[e]) * self.block_tokens
                   for e in range(self.n) if e != rank)

    def issued_rounds(self, elide_dummy=False):
        """Dispatch ``dma_start`` rounds each rank issues: the legacy
        interpreter's lockstep rule pads every edge to ``b_max`` rounds;
        real hardware (``elide_dummy``) issues only the real microblocks
        (rank r's edge to expert e carries ``blocks[e]``, so the dispatch
        total is identical on every rank)."""
        if elide_dummy:
            return int(sum(self.blocks))
        return self.n * self.b_max

    def combine_issued_rounds(self, rank=0, elide_dummy=False):
        """Combine ``dma_start`` rounds rank ``rank`` issues. Unlike
        dispatch this is rank-dependent: expert ``rank`` returns its own
        ``blocks[rank]`` real microblocks to each of the n sources."""
        if elide_dummy:
            return self.n * int(self.blocks[rank])
        return self.n * self.b_max

    def combine_ticks(self, combine_tile=None, rank=0, elide_dummy=False):
        """Per-tile combine writes (COUNTER ticks) of the tile-fused path:
        each issued combine round splits into ``block_tokens/combine_tile``
        sub-tile DMAs, each bumping the receive semaphore independently."""
        ct = sanitize_combine_tile(combine_tile, self.block_tokens)
        return self.combine_issued_rounds(rank, elide_dummy) \
            * (self.block_tokens // ct)

    def degrade(self, live_ranks, capacity_factor=1.25):
        """Respill the dead experts' tokens across the survivors
        (:func:`respill_counts`) and rebuild the permutation schedule at
        ``n = len(live)`` — token-conserving, same ``block_tokens``/
        ``tight`` realization."""
        live = check_live(live_ranks, self.n)
        if len(live) == self.n:
            return self
        return make_schedule(
            respill_counts(self.counts, live, capacity_factor),
            self.block_tokens, self.tight)


def make_schedule(counts, block_tokens=64, tight=True):
    counts = tuple(int(c) for c in counts)
    return DispatchSchedule(
        n=len(counts), block_tokens=block_tokens, counts=counts,
        blocks=tuple(block_counts(counts, block_tokens, tight)), tight=tight)


# ----------------------------------------------------------- gemm_allgather


@dataclass(frozen=True)
class BroadcastSchedule(CollectiveSchedule):
    """Trace-time broadcast-round schedule + wire accounting (rows/rank).

    ``rounds`` is the lockstep round list ``[(off, t), ...]``: in round
    ``(off, t)`` rank ``r`` sends rows ``[t*rows_per_round, ...)`` of its
    slab to peer ``(r + off) % n`` and receives the matching rows from
    ``(r - off) % n`` — a shift permutation (exactly one incoming copy per
    rank per round), identical on every rank. The fused schedule is
    tile-major so tile ``t``'s rounds issue before tile ``t+1`` computes;
    the DEFERRED schedule is one whole-slab round per offset. The
    broadcast is *dense* (every rank ships every tile to every peer), so
    there are no dummy rounds and nothing to elide.
    """
    n: int
    M_l: int
    tile_m: int              # sanitized: always divides M_l
    fused: bool

    @property
    def nt(self):
        return self.M_l // self.tile_m

    @property
    def rows_per_round(self):
        return self.tile_m if self.fused else self.M_l

    @property
    def rounds(self):
        if self.fused:
            return [(off, t) for t in range(self.nt)
                    for off in range(1, self.n)]
        return [(off, 0) for off in range(1, self.n)]

    def wire_rows(self, rank=0):
        """Rows each rank broadcasts off-rank (dense: identical on every
        rank, and identical for the fused and deferred schedules — the
        schedule changes *when* rows move, never how many)."""
        return (self.n - 1) * self.M_l

    def completion_ticks(self, counter=True):
        """Receive-side readiness ticks: COUNTER consumes arrivals one
        tile at a time (one tick per inbound ``(src, tile)`` edge); SIGNAL
        and the DEFERRED slab path wait once per inbound edge."""
        if self.fused and counter:
            return (self.n - 1) * self.nt
        return self.n - 1

    def degrade(self, live_ranks):
        """Splice the dead ranks out of the shift permutation: offsets run
        ``1..len(live)-1`` over the compacted rank space — same slab, same
        tile realization, fewer broadcast targets."""
        live = check_live(live_ranks, self.n)
        if len(live) == self.n:
            return self
        return make_broadcast_schedule(len(live), self.M_l, self.tile_m,
                                       self.fused)


def make_broadcast_schedule(n_dev, M_l, tile_m=128, fused=True):
    return BroadcastSchedule(n=int(n_dev), M_l=int(M_l),
                             tile_m=sanitize_tile_m(tile_m, M_l),
                             fused=bool(fused))


# ------------------------------------------------- ring workloads (rotation)


@dataclass(frozen=True)
class RingSchedule(CollectiveSchedule):
    """Trace-time ring-rotation schedule (ring_attention KV rotation and
    the kv_shuttle prefill→decode tile chain).

    ``rounds`` is the lockstep round list ``[(step, c), ...]``: in rotation
    step ``step`` every rank ships the shard it currently holds one hop
    around the ring (rank ``r`` → ``(r + 1) % n`` — a shift permutation),
    split into ``nc`` chunks of ``kv_chunk`` rows. The fused schedule is
    chunk-major *within* a step: chunk ``c``'s send issues before chunk
    ``c + 1``'s compute, and the receiver ticks arrivals off one chunk at
    a time (consume chunk ``c`` of step ``s-1`` while chunk ``c+1`` is
    still in flight — the FLUX point for rings). The DEFERRED schedule is
    one whole-shard round per step. One round moves ``rows_per_round``
    rows of **each** rotated tensor (K and V ship as a pair).

    ``n = 2`` with a single step is the kv_shuttle degenerate ring: the
    prefill rank's K/V tiles chain to the decode rank chunk by chunk.
    """
    n: int
    rows: int                # KV rows per shard (local sequence length)
    kv_chunk: int            # sanitized: always divides rows
    fused: bool

    @property
    def nc(self):
        return self.rows // self.kv_chunk

    @property
    def steps(self):
        return max(0, self.n - 1)

    @property
    def rows_per_round(self):
        return self.kv_chunk if self.fused else self.rows

    @property
    def rounds(self):
        if self.fused:
            return [(step, c) for step in range(self.steps)
                    for c in range(self.nc)]
        return [(step, 0) for step in range(self.steps)]

    def wire_rows(self, rank=0):
        """Rows of each rotated tensor every rank ships off-rank: the ring
        is dense and symmetric — ``(n-1) * rows`` regardless of chunking
        (the schedule changes *when* rows move, never how many)."""
        return self.steps * self.rows

    def completion_ticks(self, counter=True):
        """Receive-side readiness ticks. The chunk-rotating (fused)
        kernels wait per-chunk semaphores regardless of completion —
        COUNTER interleaves the ticks with the chunk compute while SIGNAL
        drains a step's chunks up front, but the executed wait count is
        identical (one per ``(step, chunk)`` event), so the model charges
        both the same (no spurious SIGNAL-dominates-FLUX artifact). The
        whole-shard DEFERRED/PIPELINED path waits once per rotation step."""
        del counter
        if self.fused:
            return self.steps * self.nc
        return self.steps

    def send_window_depths(self, contexts):
        """The ring kernels drain the send window at every step boundary
        (the slot-reuse credit handshake needs a step's sends retired
        before the consumer ACKs upstream), so the in-flight depth resets
        per step — the base mirror, which windows the whole round list,
        would overstate the carried depth for rings. Every step has the
        same round count, so one step's depth profile repeats."""
        per_step = send_window_depths(range(self.nc if self.fused else 1),
                                      contexts)
        return per_step * self.steps

    def degrade(self, live_ranks):
        """Splice the dead ranks out of the rotation: the ring closes over
        the compacted live order (``len(live) - 1`` shift steps) — same
        shard rows, same chunking, fewer rotation hops."""
        live = check_live(live_ranks, self.n)
        if len(live) == self.n:
            return self
        return make_ring_schedule(len(live), self.rows, self.kv_chunk,
                                  self.fused)


def make_ring_schedule(n_dev, rows, kv_chunk=None, fused=True):
    return RingSchedule(n=int(n_dev), rows=int(rows),
                        kv_chunk=sanitize_kv_chunk(kv_chunk, rows),
                        fused=bool(fused))
