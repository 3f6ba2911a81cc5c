"""Static schedule sanitizer — the cascade's l0 level.

A symbolic per-rank executor over a :class:`CollectiveSchedule`'s round
order that proves the schedule contract *without running a kernel*:

* **deadlock freedom** — every semaphore wait has a matching signal under
  the lockstep rule, and no DMA issue is role-predicated (the
  ``repro/compat.py`` rule: the legacy 0.4.x lockstep interpreter cannot
  discharge a ``pl.when``-guarded ``dma.start``);
* **slot-reuse races** — a ``sem_slot`` / VMEM double-buffer slot is never
  overwritten before its arrival tick is consumed, for every ``contexts``
  depth in ``TUNABLES``;
* **window-cap and drain invariants** — the in-flight send depth never
  exceeds ``contexts`` and the window drains where the kernel assumes;
* **conservation** — tight-wire token/row accounting balances per edge,
  including ``degrade(live_ranks)`` respills and splices (no DMA names a
  dead rank).

The pipeline is ``lower_schedule`` (schedule + kernel knobs -> a
:class:`Program` of per-rank :class:`Op` lists that mirrors what the four
kernels actually issue) then ``verify_program`` (static scans + a
vector-clock lockstep execution).  ``verify_directive`` is the cascade's
l0 entry point; ``mutation_corpus`` seeds the known bug classes that
prove the checker finds real bugs.

Modeling notes (one deliberate simplification each):

* Semaphore ticks are counted in **payload rows**, not elements — the
  kernels' element counts are ``rows * row_elems`` with a fixed row
  width per semaphore family, so the accounting is isomorphic and the
  tile-split combine balances exactly.
* A K/V chunk pair (and a data+scale pair) folds into one descriptor per
  round entry where the kernel `amend`s the window — the window depth
  and the signal counts are what the contract constrains.
* Delivery is in-order per ``(src, dst, semaphore)`` — the lockstep
  interpreter's semantics, and the strongest assumption any of the four
  kernels makes (real-block-before-dummy consumption in moe_dispatch's
  pipelined wait depends on it).

Port copy of ``repro/core/verify.py``. ``lower_dispatch`` still mirrors the
lockstep path with dummy rounds; the Hopper kernel elides them, and an
elided lowering is still to be written.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.design_space import TUNABLES
from repro_torch.core.schedule import (BroadcastSchedule, CollectiveSchedule,
                                 DispatchSchedule, RingSchedule, check_live,
                                 sanitize_combine_tile)

# ------------------------------------------------------------ checker catalog

# code -> one-line description; docs/static-analysis.md renders this table
# and tools/schedule_lint.py prints it under --catalog
CHECKS = {
    "role-predicated-dma": "a DMA issue is predicated on rank role — the "
        "legacy lockstep interpreter cannot discharge it (compat.py rule)",
    "lockstep-order": "round order is not the lockstep total order: "
        "non-monotone round issue on a rank, or a round's send/receive "
        "multiset is not a balanced permutation over the live ranks",
    "dead-rank-dma": "a DMA names a rank outside the live set (degrade "
        "splice violation: unbounded wait on real hardware)",
    "conservation": "tight-wire token/row accounting does not balance per "
        "edge (includes non-conserving degrade(live_ranks) respills)",
    "deadlock": "a semaphore wait can never be satisfied — the lockstep "
        "execution stalls with no matching signal in flight",
    "unmatched-signal": "a semaphore signal is never consumed (leftover "
        "arrival ticks at program end)",
    "slot-reuse": "a receive slot is overwritten before its previous "
        "occupant's arrival tick and reads are provably consumed",
    "stale-read": "a buffer read is not ordered after the write that "
        "produced the data it consumes (short/off-by-one tick)",
    "window-overflow": "in-flight send depth exceeds the contexts cap "
        "(send_window_depths contract)",
    "missing-drain": "send-window entries left in flight where the kernel "
        "assumes a drain (step/phase boundary)",
}

MUTATION_CLASSES = (
    "dropped_signal", "premature_slot_reuse", "window_overflow",
    "dead_rank_dma", "non_conserving_respill", "role_predicated",
    "reordered_round", "off_by_one_tick",
)

# mutation class -> the checker code that must flag it (class-specific
# diagnostics: each seeded bug is caught by its own check, not a generic
# failure downstream)
EXPECTED_CODE = {
    "dropped_signal": "deadlock",
    "premature_slot_reuse": "slot-reuse",
    "window_overflow": "window-overflow",
    "dead_rank_dma": "dead-rank-dma",
    "non_conserving_respill": "conservation",
    "role_predicated": "role-predicated-dma",
    "reordered_round": "lockstep-order",
    "off_by_one_tick": "stale-read",
}

_MAX_ERRORS = 24
_TRASH = "trash"


# ---------------------------------------------------------------- data model


@dataclass(frozen=True)
class Op:
    """One symbolic kernel action on one rank.

    ``kind``:
      * ``dma``       — start a remote copy: ``reads`` local regions, writes
                        ``writes`` regions at ``dst`` and (iff ``signals``)
                        enqueues ``rows`` arrival ticks on ``(dst, sem)``.
                        ``opens`` opens a new send-window entry; ``False``
                        amends the current one (K/V pair, data+scale pair).
      * ``wait``      — consume ``rows`` arrival ticks from ``(rank, sem)``.
      * ``wait_send`` — retire the oldest in-flight send-window entry.
      * ``write``     — local compute producing ``writes`` regions.
      * ``read``      — local compute consuming ``reads`` regions.
      * ``signal``    — bump ``(dst, sem)`` by ``rows`` with no payload
                        (the ring credit handshake).
    """
    kind: str
    phase: str = ""
    rnd: int = -1
    dst: int = -1
    sem: tuple = ()
    rows: int = 0
    writes: tuple = ()
    reads: tuple = ()
    predicate: object = None     # role predicate marker (contract violation)
    signals: bool = True         # dma only: bump the receive semaphore
    dummy: bool = False          # trash-row round (excluded from conservation)
    opens: bool = True           # dma only: opens a new window entry
    counted: bool = True         # dma only: counts toward edge conservation
    label: str = ""


@dataclass
class Program:
    """A lowered schedule: per-rank op lists plus the expected accounting."""
    n: int
    contexts: int
    ops: list                    # ops[r] = rank r's Op list, program order
    live: tuple
    edge_rows: dict              # (phase, src, dst) -> expected real rows
    subject: str = ""
    meta: dict = field(default_factory=dict)

    def clone(self):
        return Program(self.n, self.contexts, [list(r) for r in self.ops],
                       self.live, dict(self.edge_rows), self.subject,
                       dict(self.meta))


@dataclass(frozen=True)
class VerifyError:
    code: str
    rank: int
    op_index: int
    detail: str

    def __str__(self):
        where = f"rank {self.rank}" if self.rank >= 0 else "schedule"
        if self.op_index >= 0:
            where += f" op {self.op_index}"
        return f"[{self.code}] {where}: {self.detail}"


@dataclass(frozen=True)
class VerifyReport:
    ok: bool
    errors: tuple
    subject: str = ""
    checked: dict = field(default_factory=dict)

    def codes(self):
        return tuple(dict.fromkeys(e.code for e in self.errors))

    def summary(self, limit=3):
        if self.ok:
            return f"ok ({self.subject})" if self.subject else "ok"
        head = "; ".join(str(e) for e in self.errors[:limit])
        more = len(self.errors) - limit
        if more > 0:
            head += f" (+{more} more)"
        return head

    @staticmethod
    def merge(reports, subject=""):
        errs, checked, seen = [], {}, set()
        for r in reports:
            for e in r.errors:
                key = (e.code, e.rank, e.op_index, e.detail)
                if key not in seen:
                    seen.add(key)
                    errs.append(e)
            for k, v in r.checked.items():
                checked[k] = checked.get(k, 0) + v
        return VerifyReport(ok=not errs, errors=tuple(errs),
                            subject=subject, checked=checked)


# ------------------------------------------------------- lowering: the mirror


class _Builder:
    """Per-rank op emission with a ``SendWindow`` depth mirror: ``push_dma``
    retires the oldest entry before issuing past the ``contexts`` cap —
    byte-for-byte the kernels' bounded-issue algorithm."""

    def __init__(self, n, contexts):
        self.n = n
        self.contexts = max(1, int(contexts))
        self.ops = [[] for _ in range(n)]
        self._depth = [0] * n

    def emit(self, r, op):
        self.ops[r].append(op)

    def push_dma(self, r, **kw):
        if self._depth[r] >= self.contexts:
            self.emit(r, Op("wait_send"))
            self._depth[r] -= 1
        self.emit(r, Op("dma", opens=True, **kw))
        self._depth[r] += 1

    def amend_dma(self, r, **kw):
        self.emit(r, Op("dma", opens=False, **kw))

    def drain(self, r):
        while self._depth[r]:
            self.emit(r, Op("wait_send"))
            self._depth[r] -= 1

    def wait(self, r, sem, rows):
        if rows > 0:
            self.emit(r, Op("wait", sem=sem, rows=int(rows)))

    def program(self, edge_rows, subject, **meta):
        return Program(self.n, self.contexts, self.ops,
                       tuple(range(self.n)), edge_rows, subject, meta)


def lower_dispatch(sched, contexts, *, wire_i8=False, tile_fused=False,
                   barrier=False, pipelined=True, combine_tile=None):
    """Mirror of ``kernels/moe_dispatch.py::_moe_kernel``: staged sends,
    the full lockstep dispatch round list (dummies to the trash row), the
    three wait realizations (barrier rendezvous / pipelined real-block
    waits + dummy residue / tile-fused per-microblock combine), and the
    reverse combine permutation."""
    n, B, b_max = sched.n, sched.block_tokens, sched.b_max
    blocks = sched.blocks
    ct = sanitize_combine_tile(combine_tile, B)
    nt = B // ct
    bld = _Builder(n, contexts)
    P1, P2 = "dispatch", "combine"

    # stage every real microblock into the send queue (+ its scale row)
    for r in range(n):
        for e in range(n):
            for j in range(blocks[e]):
                bld.emit(r, Op("write", writes=(("send", e, j),)))
                if wire_i8:
                    bld.emit(r, Op("write", writes=(("sends", e, j),)))

    # lockstep dispatch rounds: rank r -> expert (r - off) % n
    for ri, (off, j) in enumerate(sched.rounds):
        for r in range(n):
            e = (r - off) % n
            real = j < blocks[e]
            bld.push_dma(
                r, phase=P1, rnd=ri, dst=e, sem=("disp", r), rows=B,
                writes=(("recv", r, j),) if real else ((_TRASH,),),
                reads=(("send", e, j),) if real else (),
                dummy=not real)
            if wire_i8:
                bld.amend_dma(
                    r, phase=P1, rnd=ri, dst=e, sem=("scale", r), rows=B,
                    writes=(("recvs", r, j),) if real else ((_TRASH,),),
                    reads=(("sends", e, j),) if real else (),
                    dummy=not real, counted=False)
    for r in range(n):
        bld.drain(r)

    def _wait_edge(r, src, nblk):
        bld.wait(r, ("disp", src), nblk * B)
        if wire_i8:
            bld.wait(r, ("scale", src), nblk * B)

    def _ffn(r, src, jlo, jhi, t=None):
        keys = tuple(("recv", src, j) for j in range(jlo, jhi))
        if wire_i8:
            keys += tuple(("recvs", src, j) for j in range(jlo, jhi))
        if keys:
            bld.emit(r, Op("read", reads=keys))
        ts = range(nt) if t is None else (t,)
        for j in range(jlo, jhi):
            for tt in ts:
                bld.emit(r, Op("write", writes=(("ffn", src, j, tt),)))

    if tile_fused:
        # per-microblock arrival waits interleaved with the sub-tile
        # combine pushes (the FLUX point) — one shared combine window
        for r in range(n):
            my = blocks[r]
            for off in range(n):
                src = (r + off) % n       # dispatch source == combine dst
                for j in range(b_max):
                    real = j < my
                    _wait_edge(r, src, 1)
                    if real:
                        _ffn(r, src, j, j + 1)
                    ri = off * b_max + j
                    for t in range(nt):
                        bld.push_dma(
                            r, phase=P2, rnd=ri, dst=src,
                            sem=("comb", r), rows=ct,
                            writes=(("comb", r, j, t),) if real
                            else ((_TRASH,),),
                            reads=(("ffn", src, j, t),) if real else (),
                            dummy=not real)
            bld.drain(r)
    else:
        if barrier or not pipelined:
            # global rendezvous: every edge lands before any expert compute
            for r in range(n):
                for s in range(n):
                    _wait_edge(r, (r + s) % n, b_max)
                for s in range(n):
                    src = (r + s) % n
                    if blocks[r]:
                        _ffn(r, src, 0, blocks[r])
        else:
            # pipelined SIGNAL: wait only the real blocks of an edge, run
            # its FFN, then tick off the dummy residue (real microblocks
            # precede dummies in the lockstep round order, so the partial
            # wait consumes exactly the real deliveries)
            for r in range(n):
                my = blocks[r]
                for s in range(n):
                    src = (r + s) % n
                    _wait_edge(r, src, my)
                    if my:
                        _ffn(r, src, 0, my)
                    _wait_edge(r, src, b_max - my)
        # combine: expert r -> source (r + off) % n, same round list
        for ri, (off, j) in enumerate(sched.rounds):
            for r in range(n):
                q = (r + off) % n
                real = j < blocks[r]
                bld.push_dma(
                    r, phase=P2, rnd=ri, dst=q, sem=("comb", r), rows=B,
                    writes=(("comb", r, j, 0),) if real else ((_TRASH,),),
                    reads=(("ffn", q, j, 0),) if real else (),
                    dummy=not real)
        for r in range(n):
            bld.drain(r)

    # final combine waits (all variants wait the padded b_max per source
    # expert) + the output assembly reads
    for r in range(n):
        for s in range(n):
            bld.wait(r, ("comb", (r + s) % n), b_max * B)
        keys = tuple(("comb", e, j, t)
                     for e in range(n) for j in range(blocks[e])
                     for t in range(nt if tile_fused else 1))
        if keys:
            bld.emit(r, Op("read", reads=keys))

    edge_rows = {}
    for r in range(n):
        for e in range(n):
            if blocks[e]:
                edge_rows[(P1, r, e)] = blocks[e] * B
        if blocks[r]:
            for q in range(n):
                edge_rows[(P2, r, q)] = blocks[r] * B
        assert sum(v for (p, s, d), v in edge_rows.items()
                   if p == P1 and s == r and d != r) \
            == sched.executed_wire_tokens(r)
    return bld.program(edge_rows, f"dispatch(n={n}, B={B}, blocks={blocks}, "
                       f"tile_fused={tile_fused}, barrier={barrier}, "
                       f"contexts={contexts})")


def lower_broadcast(sched, contexts, *, counter=True):
    """Mirror of ``kernels/gemm_allgather.py::_ga_kernel``: tile-major
    fused rounds (COUNTER ticks trail the issue by one tile) or the
    deferred whole-slab rounds."""
    n, M_l, tm, nt = sched.n, sched.M_l, sched.tile_m, sched.nt
    bld = _Builder(n, contexts)
    PH = "bcast"

    if sched.fused:
        for t in range(nt):
            for r in range(n):
                bld.emit(r, Op("write", writes=(("slab", r, t),)))
            for off in range(1, n):
                ri = t * (n - 1) + (off - 1)
                for r in range(n):
                    bld.push_dma(
                        r, phase=PH, rnd=ri, dst=(r + off) % n,
                        sem=("bcast", r), rows=tm,
                        writes=(("slab", r, t),), reads=(("slab", r, t),))
            if counter and t > 0:
                # consume tile t-1 arrivals while tile t is in flight
                for off in range(1, n):
                    for r in range(n):
                        src = (r - off) % n
                        bld.wait(r, ("bcast", src), tm)
                        bld.emit(r, Op("read", reads=(("slab", src, t - 1),)))
        for r in range(n):
            bld.drain(r)
        for off in range(1, n):
            for r in range(n):
                src = (r - off) % n
                if counter:
                    bld.wait(r, ("bcast", src), tm)
                    bld.emit(r, Op("read", reads=(("slab", src, nt - 1),)))
                else:
                    bld.wait(r, ("bcast", src), nt * tm)
                    bld.emit(r, Op("read", reads=tuple(
                        ("slab", src, t) for t in range(nt))))
    else:
        for r in range(n):
            bld.emit(r, Op("write", writes=(("slab", r),)))
        for ri, (off, _t) in enumerate(sched.rounds):
            for r in range(n):
                bld.push_dma(r, phase=PH, rnd=ri, dst=(r + off) % n,
                             sem=("bcast", r), rows=M_l,
                             writes=(("slab", r),), reads=(("slab", r),))
        for r in range(n):
            bld.drain(r)
        for off in range(1, n):
            for r in range(n):
                src = (r - off) % n
                bld.wait(r, ("bcast", src), M_l)
                bld.emit(r, Op("read", reads=(("slab", src),)))

    edge_rows = {(PH, r, (r + off) % n): M_l
                 for r in range(n) for off in range(1, n)}
    for r in range(n):
        assert sum(v for (p, s, d), v in edge_rows.items() if s == r) \
            == sched.wire_rows(r)
    return bld.program(edge_rows, f"broadcast(n={n}, M_l={M_l}, tile_m={tm}, "
                       f"fused={sched.fused}, counter={counter}, "
                       f"contexts={contexts})")


def lower_ring(sched, contexts, *, counter=True, pipelined=True, eager=False):
    """Mirror of ``kernels/ring_attention.py::_ring_kernel`` (and the
    kv_shuttle degenerate ring): alternating VMEM slots, the per-step
    credit handshake that proves slot WAR safety, chunk-interleaved
    COUNTER ticks vs up-front SIGNAL drains, and the whole-shard
    eager/lazy fence variants."""
    n, nc, cr = sched.n, sched.nc, sched.kv_chunk
    steps = sched.steps
    bld = _Builder(n, contexts)
    PH = "ring"
    fused = sched.fused

    for r in range(n):
        if fused:
            for c in range(nc):
                bld.emit(r, Op("write", writes=(("kv", 0, c),)))
        else:
            bld.emit(r, Op("write", writes=(("kv", 0),)))

    for s in range(n):
        slot = s % 2
        rotate = s <= n - 2
        if rotate and s >= 1:
            for r in range(n):
                bld.wait(r, ("credit",), 1)
        if fused:
            if not counter and s >= 1:
                # SIGNAL drains the whole step's ticks up front
                for c in range(nc):
                    for r in range(n):
                        bld.wait(r, ("kvrecv", c), cr)
            for c in range(nc):
                if counter and s >= 1:
                    for r in range(n):
                        bld.wait(r, ("kvrecv", c), cr)
                if rotate:
                    ri = s * nc + c
                    for r in range(n):
                        bld.push_dma(
                            r, phase=PH, rnd=ri, dst=(r + 1) % n,
                            sem=("kvrecv", c), rows=cr,
                            writes=(("kv", 1 - slot, c),),
                            reads=(("kv", slot, c),))
                for r in range(n):
                    bld.emit(r, Op("read", reads=(("kv", slot, c),)))
            for r in range(n):
                bld.drain(r)
        else:
            if rotate:
                ri = s
                for r in range(n):
                    bld.push_dma(r, phase=PH, rnd=ri, dst=(r + 1) % n,
                                 sem=("kvrecv", 0), rows=sched.rows,
                                 writes=(("kv", 1 - slot),),
                                 reads=(("kv", slot),))
                if eager or not pipelined:
                    for r in range(n):
                        bld.drain(r)
                        bld.wait(r, ("kvrecv", 0), sched.rows)
            for r in range(n):
                bld.emit(r, Op("read", reads=(("kv", slot),)))
            if rotate and pipelined and not eager:
                for r in range(n):
                    bld.drain(r)
                    bld.wait(r, ("kvrecv", 0), sched.rows)
        if s <= n - 3:
            for r in range(n):
                bld.emit(r, Op("signal", dst=(r - 1) % n,
                               sem=("credit",), rows=1))

    edge_rows = {}
    if steps:
        edge_rows = {(PH, r, (r + 1) % n): steps * sched.rows
                     for r in range(n)}
        for r in range(n):
            assert edge_rows[(PH, r, (r + 1) % n)] == sched.wire_rows(r)
    return bld.program(edge_rows, f"ring(n={n}, rows={sched.rows}, "
                       f"kv_chunk={cr}, fused={fused}, counter={counter}, "
                       f"contexts={contexts})")


def lower_schedule(sched, contexts, knobs=None):
    """Type-dispatched lowering: a schedule plus the workload's
    ``kernel_knobs`` realization -> the symbolic :class:`Program` the
    matching kernel would issue."""
    k = dict(knobs or {})
    if isinstance(sched, DispatchSchedule):
        return lower_dispatch(
            sched, contexts,
            wire_i8=bool(k.get("wire_i8", False)),
            tile_fused=bool(k.get("tile_fused", False)),
            barrier=bool(k.get("barrier", False)),
            pipelined=bool(k.get("pipelined", True)),
            combine_tile=k.get("combine_tile"))
    if isinstance(sched, BroadcastSchedule):
        return lower_broadcast(sched, contexts,
                               counter=bool(k.get("counter", True)))
    if isinstance(sched, RingSchedule):
        return lower_ring(sched, contexts,
                          counter=bool(k.get("counter", True)),
                          pipelined=bool(k.get("pipelined", True)),
                          eager=bool(k.get("eager", False)))
    raise TypeError(f"no lowering for {type(sched).__name__}")


# ----------------------------------------------------- the symbolic executor


class _Write:
    __slots__ = ("clock", "consumers", "label")

    def __init__(self, clock, label):
        self.clock = clock
        self.consumers = []
        self.label = label


class _Delivery:
    __slots__ = ("rows", "clock", "writes", "signaled")

    def __init__(self, rows, clock, writes, signaled):
        self.rows = rows
        self.clock = clock
        self.writes = writes
        self.signaled = signaled


class _Region:
    __slots__ = ("writes", "open_reads")

    def __init__(self):
        self.writes = []
        self.open_reads = []       # (write-or-None, start clock, reader rank)


def _leq(a, b):
    return all(x <= y for x, y in zip(a, b))


class _Executor:
    """Vector-clock lockstep execution of a :class:`Program`.

    Round-robin, one op per rank per pass; a ``wait`` whose semaphore
    deficit cannot yet be met blocks its rank.  Happens-before is the
    standard vector-clock order: joins flow only through *fully consumed*
    semaphore deliveries, so a short (off-by-one) wait leaves the arrival
    unordered and the subsequent read is flagged stale.  WAR safety
    requires every consumption of a slot's previous occupant (arrival
    ticks, compute reads, retired outbound-DMA reads) to happen-before
    the overwriting DMA's start."""

    def __init__(self, prog):
        self.p = prog
        self.errors = []
        self.clock = [[0] * prog.n for _ in range(prog.n)]
        self.window = [[] for _ in range(prog.n)]     # entries: [dma records]
        self.pending = {}        # (rank, sem) -> list of _Delivery (FIFO)
        self.unsignaled = {}     # (rank, sem) -> rows delivered sans signal
        self.regions = {}        # (rank, key) -> _Region
        self.ops_run = 0

    def err(self, code, rank, idx, detail):
        if len(self.errors) < _MAX_ERRORS:
            self.errors.append(VerifyError(code, rank, idx, detail))

    def region(self, rank, key):
        return self.regions.setdefault((rank, key), _Region())

    def _event(self, r):
        self.clock[r][r] += 1

    def _do_write(self, r, dst, key, ec, idx, label):
        if key[0] == _TRASH:
            return None
        reg = self.region(dst, key)
        if reg.writes:
            prev = reg.writes[-1]
            if not prev.consumers:
                self.err("slot-reuse", r, idx,
                         f"{key} at rank {dst} overwritten before any "
                         f"consumption of {prev.label}")
            else:
                for c in prev.consumers:
                    if not _leq(c, ec):
                        self.err("slot-reuse", r, idx,
                                 f"{key} at rank {dst} overwritten by "
                                 f"{label} before a consumption of "
                                 f"{prev.label} is ordered first")
                        break
        for _w, _c, reader in reg.open_reads:
            self.err("slot-reuse", r, idx,
                     f"{key} at rank {dst} overwritten while an outbound "
                     f"DMA read from rank {reader} is still in flight")
            break
        w = _Write(ec, label)
        reg.writes.append(w)
        return w

    def _check_read(self, r, key, ec, idx, what):
        reg = self.region(r, key)
        if reg.writes:
            w = reg.writes[-1]
            if not _leq(w.clock, ec):
                self.err("stale-read", r, idx,
                         f"{what} of {key} is not ordered after the write "
                         f"{w.label} it consumes")
            return w
        return None

    def _exec(self, r, op, idx):
        self.ops_run += 1
        k = op.kind
        if k == "dma":
            self._event(r)
            ec = tuple(self.clock[r])
            rec_reads = []
            for key in op.reads:
                w = self._check_read(r, key, ec, idx,
                                     f"DMA source read (round {op.rnd})")
                reg = self.region(r, key)
                entry = (w, ec, r)
                reg.open_reads.append(entry)
                rec_reads.append((reg, entry))
            if op.opens:
                if len(self.window[r]) >= self.p.contexts:
                    self.err("window-overflow", r, idx,
                             f"send depth {len(self.window[r]) + 1} exceeds "
                             f"contexts={self.p.contexts} at round {op.rnd}")
                self.window[r].append([rec_reads])
            elif self.window[r]:
                self.window[r][-1].append(rec_reads)
            writes = []
            label = f"DMA round {op.rnd} from rank {r}"
            for key in op.writes:
                w = self._do_write(r, op.dst, key, ec, idx, label)
                if w is not None:
                    writes.append(w)
            d = _Delivery(op.rows, ec, writes, op.signals)
            if op.signals:
                self.pending.setdefault((op.dst, op.sem), []).append(d)
            else:
                key = (op.dst, op.sem)
                self.unsignaled[key] = self.unsignaled.get(key, 0) + op.rows
        elif k == "signal":
            self._event(r)
            ec = tuple(self.clock[r])
            self.pending.setdefault((op.dst, op.sem), []).append(
                _Delivery(op.rows, ec, [], True))
        elif k == "wait":
            self._event(r)
            need = op.rows
            q = self.pending.get((r, op.sem), [])
            joined = []
            while need and q:
                d = q[0]
                take = min(need, d.rows)
                d.rows -= take
                need -= take
                if d.rows == 0:
                    q.pop(0)
                    joined.append(d)
            # joins flow only through fully consumed deliveries; a partial
            # consumption leaves the arrival unordered (stale-read ahead)
            for d in joined:
                self.clock[r] = [max(a, b)
                                 for a, b in zip(self.clock[r], d.clock)]
            ec = tuple(self.clock[r])
            for d in joined:
                for w in d.writes:
                    w.consumers.append(ec)
        elif k == "wait_send":
            self._event(r)
            ec = tuple(self.clock[r])
            if not self.window[r]:
                self.err("window-overflow", r, idx,
                         "send-window retire with nothing in flight")
                return
            entry = self.window[r].pop(0)
            for rec_reads in entry:
                for reg, oread in rec_reads:
                    if oread in reg.open_reads:
                        reg.open_reads.remove(oread)
                    w = oread[0]
                    if w is not None:
                        w.consumers.append(ec)
        elif k == "write":
            self._event(r)
            ec = tuple(self.clock[r])
            for key in op.writes:
                self._do_write(r, r, key, ec, idx, f"compute write at {idx}")
        elif k == "read":
            self._event(r)
            ec = tuple(self.clock[r])
            for key in op.reads:
                w = self._check_read(r, key, ec, idx, "compute read")
                if w is not None:
                    w.consumers.append(ec)

    def _can_wait(self, r, op):
        have = sum(d.rows for d in self.pending.get((r, op.sem), []))
        return have >= op.rows

    def run(self):
        p = self.p
        pcs = [0] * p.n
        while True:
            progressed, alldone = False, True
            for r in range(p.n):
                if pcs[r] >= len(p.ops[r]):
                    continue
                alldone = False
                op = p.ops[r][pcs[r]]
                if op.kind == "wait" and not self._can_wait(r, op):
                    continue
                self._exec(r, op, pcs[r])
                pcs[r] += 1
                progressed = True
            if alldone:
                break
            if not progressed:
                self._deadlock(pcs)
                return
            if len(self.errors) >= _MAX_ERRORS:
                return
        self._end_state()

    def _deadlock(self, pcs):
        for r in range(self.p.n):
            if pcs[r] >= len(self.p.ops[r]):
                continue
            op = self.p.ops[r][pcs[r]]
            have = sum(d.rows for d in self.pending.get((r, op.sem), []))
            detail = (f"wait on {op.sem} stalls forever: have {have} of "
                      f"{op.rows} rows signaled")
            ghost = self.unsignaled.get((r, op.sem), 0)
            if ghost:
                detail += f" ({ghost} rows delivered without a signal)"
            self.err("deadlock", r, pcs[r], detail)

    def _end_state(self):
        for r in range(self.p.n):
            if self.window[r]:
                self.err("missing-drain", r, len(self.p.ops[r]) - 1,
                         f"{len(self.window[r])} send-window entries left "
                         f"in flight at program end")
        for (r, sem), q in sorted(self.pending.items(), key=str):
            left = sum(d.rows for d in q)
            if left:
                self.err("unmatched-signal", r, len(self.p.ops[r]) - 1,
                         f"{left} arrival rows on {sem} never consumed")


# ------------------------------------------------------------- static checks


def _static_errors(prog):
    errs = []
    live = set(prog.live)
    for r in range(prog.n):
        for idx, op in enumerate(prog.ops[r]):
            if op.kind == "dma" and op.predicate is not None:
                errs.append(VerifyError(
                    "role-predicated-dma", r, idx,
                    f"DMA issue at round {op.rnd} predicated on role "
                    f"{op.predicate!r} — the legacy lockstep interpreter "
                    f"cannot discharge it"))
            if op.kind in ("dma", "signal") and op.dst not in live:
                errs.append(VerifyError(
                    "dead-rank-dma", r, idx,
                    f"{op.kind} names rank {op.dst}, outside the live set "
                    f"{tuple(sorted(live))}"))
    # lockstep total order: per-rank monotone round issue, and every round
    # a balanced permutation (same send and receive multiplicity on every
    # live rank)
    per_round = {}
    for r in range(prog.n):
        last = {}
        for idx, op in enumerate(prog.ops[r]):
            if op.kind != "dma" or not op.opens:
                continue
            if op.rnd < last.get(op.phase, -1):
                errs.append(VerifyError(
                    "lockstep-order", r, idx,
                    f"{op.phase} round {op.rnd} issued after round "
                    f"{last[op.phase]} — not the lockstep total order"))
            last[op.phase] = max(last.get(op.phase, -1), op.rnd)
            snd, rcv = per_round.setdefault((op.phase, op.rnd), ({}, {}))
            snd[r] = snd.get(r, 0) + 1
            if op.dst in live:
                rcv[op.dst] = rcv.get(op.dst, 0) + 1
    for (phase, rnd), (snd, rcv) in sorted(per_round.items()):
        for name, m in (("send", snd), ("receive", rcv)):
            counts = {m.get(r, 0) for r in prog.live}
            if len(counts) > 1:
                errs.append(VerifyError(
                    "lockstep-order", -1, -1,
                    f"{phase} round {rnd} is not a balanced permutation: "
                    f"per-rank {name} counts differ"))
                break
    return errs


def _conservation_errors(prog):
    got = {}
    for r in range(prog.n):
        for op in prog.ops[r]:
            if op.kind == "dma" and op.counted and not op.dummy and op.phase:
                key = (op.phase, r, op.dst)
                got[key] = got.get(key, 0) + op.rows
    errs = []
    for key in sorted(set(got) | set(prog.edge_rows)):
        g, w = got.get(key, 0), prog.edge_rows.get(key, 0)
        if g != w:
            phase, src, dst = key
            errs.append(VerifyError(
                "conservation", src, -1,
                f"{phase} edge {src}->{dst} moves {g} rows, accounting "
                f"requires {w}"))
            if len(errs) >= 8:
                break
    return errs


def degrade_errors(parent, live_ranks, degraded):
    """Schedule-level degrade/splice contract: the degraded schedule must
    be a smaller same-class instance over the compacted live set, and the
    respill must conserve what the class conserves (tokens for dispatch,
    slab rows for broadcast, shard rows for rings)."""
    live = check_live(live_ranks, parent.n)
    errs = []

    def bad(detail):
        errs.append(VerifyError("conservation", -1, -1, detail))

    if type(degraded) is not type(parent):
        bad(f"degrade changed schedule class: {type(parent).__name__} -> "
            f"{type(degraded).__name__}")
        return errs
    if degraded.n != len(live):
        bad(f"degraded n={degraded.n} != {len(live)} live ranks")
    if isinstance(parent, DispatchSchedule):
        if sum(degraded.counts) != sum(parent.counts):
            bad(f"respill is not token-conserving: {sum(parent.counts)} "
                f"tokens before, {sum(degraded.counts)} after")
        if degraded.block_tokens != parent.block_tokens:
            bad("respill changed the microblock realization "
                f"(block_tokens {parent.block_tokens} -> "
                f"{degraded.block_tokens})")
    elif isinstance(parent, BroadcastSchedule):
        if degraded.M_l != parent.M_l:
            bad(f"degrade changed the local slab: M_l {parent.M_l} -> "
                f"{degraded.M_l}")
    elif isinstance(parent, RingSchedule):
        if degraded.rows != parent.rows:
            bad(f"degrade changed the KV shard: rows {parent.rows} -> "
                f"{degraded.rows}")
    return errs


# ------------------------------------------------------------ the public API


def verify_program(prog):
    """Run every check on one lowered :class:`Program`.  Static scans
    (role predication, dead ranks, lockstep order, conservation) run
    first and short-circuit the symbolic execution — a malformed program
    would only cascade noise through it."""
    errs = _static_errors(prog)
    errs += _conservation_errors(prog)
    checked = {"programs": 1,
               "ops": sum(len(r) for r in prog.ops)}
    if errs:
        return VerifyReport(False, tuple(errs[:_MAX_ERRORS]), prog.subject,
                            checked)
    ex = _Executor(prog)
    ex.run()
    checked["ops_executed"] = ex.ops_run
    return VerifyReport(not ex.errors, tuple(ex.errors), prog.subject,
                        checked)


def verify_schedule(sched, *, contexts=None, knobs=None, parent=None,
                    live=None):
    """Verify a schedule across window depths (default: the full
    ``TUNABLES['contexts']`` grid).  ``parent``/``live`` additionally
    check the degrade/splice contract against the schedule this one was
    degraded from."""
    reports = []
    if parent is not None:
        derrs = degrade_errors(parent, live, sched)
        if derrs:
            reports.append(VerifyReport(False, tuple(derrs),
                                        "degrade contract", {}))
    depths = tuple(contexts) if contexts else tuple(TUNABLES["contexts"])
    for cx in depths:
        reports.append(verify_program(lower_schedule(sched, cx, knobs)))
    return VerifyReport.merge(
        reports, subject=f"{type(sched).__name__} x contexts={depths}")


def directive_programs(workload, d):
    """The symbolic programs a directive would issue on ``workload``:
    ``[]`` when the realization has no collective schedule (XLA backends,
    the kv solo tier)."""
    fn = getattr(workload, "collective_schedule", None)
    sched = fn(d) if fn is not None else None
    if sched is None:
        return []
    knobs = workload.kernel_knobs(d)
    cx = max(1, int(knobs.get("contexts", 1)))
    name = f"{type(sched).__name__}@contexts={cx}"
    return [(name, lower_schedule(sched, cx, knobs))]


def verify_directive(workload, d):
    """The cascade's l0 entry point: verify every program the directive
    realizes at its own window depth.  ``None`` means vacuously clean —
    the directive issues no collective schedule at all."""
    progs = directive_programs(workload, d)
    if not progs:
        return None
    return VerifyReport.merge(
        [verify_program(p) for _name, p in progs],
        subject="; ".join(p.subject for _name, p in progs))


# -------------------------------------------------- seeded-mutation corpus


def apply_mutation(prog, cls, rank=0):
    """Seed one known bug class into a clean program (a fresh clone).
    Raises ``ValueError`` when the class does not apply to this program
    (or is schedule-level, like ``non_conserving_respill``)."""
    p = prog.clone()
    ops = p.ops[rank]

    def find(pred):
        for i, op in enumerate(ops):
            if pred(op):
                return i
        raise ValueError(f"mutation {cls!r} does not apply to {p.subject}")

    if cls == "dropped_signal":
        i = find(lambda o: o.kind == "dma" and o.signals and not o.dummy)
        ops[i] = dataclasses.replace(ops[i], signals=False)
    elif cls == "premature_slot_reuse":
        i = find(lambda o: o.kind == "wait" and o.sem == ("credit",))
        del ops[i]
    elif cls == "window_overflow":
        i = find(lambda o: o.kind == "wait_send")
        del ops[i]
    elif cls == "dead_rank_dma":
        i = find(lambda o: o.kind == "dma" and not o.dummy)
        ops[i] = dataclasses.replace(ops[i], dst=p.n)
    elif cls == "role_predicated":
        i = find(lambda o: o.kind == "dma")
        ops[i] = dataclasses.replace(ops[i], predicate=rank)
    elif cls == "reordered_round":
        i = find(lambda o: o.kind == "dma" and o.opens)
        j = find(lambda o: o.kind == "dma" and o.opens
                 and o.phase == ops[i].phase and o.rnd > ops[i].rnd)
        ops[i], ops[j] = ops[j], ops[i]
    elif cls == "off_by_one_tick":
        i = find(lambda o: o.kind == "wait" and o.rows > 1)
        ops[i] = dataclasses.replace(ops[i], rows=ops[i].rows - 1)
    elif cls == "non_conserving_respill":
        raise ValueError("non_conserving_respill is schedule-level — use "
                         "degrade_errors/verify_schedule(parent=, live=)")
    else:
        raise ValueError(f"unknown mutation class {cls!r}")
    p.subject = f"{p.subject} + {cls}"
    return p


def mutation_corpus():
    """One seeded instance per :data:`MUTATION_CLASSES` entry over
    representative schedules of all four kernels.  Each entry carries the
    class, the checker code expected to flag it, and a ``run`` thunk
    returning the :class:`VerifyReport` — the proof obligation is
    ``entry['expect'] in run().codes()`` with the expected code first."""
    from repro_torch.core.schedule import (make_broadcast_schedule,
                                     make_ring_schedule, make_schedule)
    disp_sched = make_schedule((96, 64, 33, 17), 32, True)
    disp = lower_dispatch(disp_sched, 2)
    ring = lower_ring(make_ring_schedule(4, 128, 32, True), 2)
    bcast = lower_broadcast(make_broadcast_schedule(4, 256, 64, True), 2)
    host = {"dropped_signal": disp, "premature_slot_reuse": ring,
            "window_overflow": bcast, "dead_rank_dma": disp,
            "role_predicated": bcast, "reordered_round": disp,
            "off_by_one_tick": ring}
    entries = []
    for cls in MUTATION_CLASSES:
        expect = EXPECTED_CODE[cls]
        if cls == "non_conserving_respill":
            live = (0, 1, 3)
            good = disp_sched.degrade(live)
            bad = DispatchSchedule(
                n=good.n, block_tokens=good.block_tokens,
                counts=(good.counts[0] + good.block_tokens,)
                + good.counts[1:],
                blocks=good.blocks, tight=good.tight)
            entries.append({
                "cls": cls, "expect": expect,
                "subject": "degraded dispatch with a tampered respill",
                "run": (lambda b=bad, l=live, p=disp_sched:
                        verify_schedule(b, contexts=(2,), parent=p, live=l)),
            })
        else:
            mut = apply_mutation(host[cls], cls)
            entries.append({"cls": cls, "expect": expect,
                            "subject": mut.subject,
                            "run": (lambda m=mut: verify_program(m))})
    return entries
