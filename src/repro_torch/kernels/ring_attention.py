"""Context-parallel ring attention (paper §4.2, App. N) as a hand-written
Hopper kernel (``repro_torch/csrc/ring_attention.cu``).

Port of ``repro/kernels/ring_attention.py``: rank r holds the query, key
and value shards of rows ``[r*Sl, (r+1)*Sl)`` of one sequence; the
key/value shards rotate one hop per step (r -> r+1) and every rank folds
each shard it holds into its queries' online softmax, against the shared
``core/schedule.py::RingSchedule``. Realizations: fused COUNTER (chunk by
chunk, each chunk waited for just before use — the FLUX point for rings),
fused SIGNAL (a step's chunks drained up front), pipelined (one
whole-shard round per step, fenced after the compute: the lazy fence),
deferred or eager (fenced before the compute). The n ranks are n CTA
partitions of one cooperative launch, each rank's CTAs in proportion to
its causal work (:func:`ring_ctas`).

Every entry takes and returns the JAX package's stacked layout, ranks on
axis 0: q/k/v ``(n, BH, Sl, hd)``, in f32 or bf16 (the reference runs in
q's dtype; the math is f32 either way). CUDA tensors launch the kernel or
raise (rows of a 16-byte multiple: hd <= 128 and a multiple of 4 in f32,
of 8 in bf16); CPU tensors compute
:func:`ring_attention_plain`, the plain version the tests and
``chip_smoke.py`` hold the kernel against. ``contexts`` (1, 2 or 4) is
the kernel's send window: each CTA keeps that many ``(step, chunk)``
rounds of bulk stores in flight and drains at every step boundary
(``csrc/window.cuh``); :func:`ring_attention_logged` runs the probe build
and :func:`check_log` holds its log to ``RingSchedule``. ``LAUNCHES``
counts launches keyed by variant and shape (``CONTEXTS_LAUNCHED`` by
``contexts``); ``VARIANTS`` names the knob sets the main path launches on
f32 inputs, ``BF16_VARIANTS`` those it launches on bf16 inputs.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import itertools
import math

import torch

from repro_torch.kernels import build, window
from repro_torch.kernels.split import cta_split

# The schedule machinery is defined once, in repro_torch.core.schedule;
# re-exported here for the kernel's callers.
from repro_torch.core.schedule import (RingSchedule,  # noqa: F401
                                       make_ring_schedule)

NEG_INF = -1e30               # the reference's masked score
MAX_HD = 128
MAX_RANKS = 16                # RING_MAXN in the CUDA source
TILE = 64                     # the kernel's query and key tile rows
TIMEOUT_MS = 20_000           # a spin-wait traps after this long
DEFAULT_CHUNK = 64            # fused kv_chunk when none is given
STALL_DEFINES = ("RING_TEST_STALL",)   # the slowed-rank test build

# (variant, n, BH, Sl, hd) -> kernel launches; read by chip_smoke.py
LAUNCHES = collections.Counter()
# contexts -> kernel launches: the directives' window reaches the card
CONTEXTS_LAUNCHED = collections.Counter()

# Knobs of each variant the main path launches (the RingAttention
# search's directives at Sl = 1024; kv_chunk is the default tunable).
VARIANTS = {
    "deferred": dict(pipelined=False, kv_chunk=64),
    "eager": dict(pipelined=True, eager_wait=True, kv_chunk=64),
    "pipelined": dict(pipelined=True, kv_chunk=64),
    "fused_signal": dict(fused=True, counter=False, kv_chunk=64),
    "fused_counter": dict(fused=True, counter=True, kv_chunk=64),
    "fused_counter_kc16": dict(fused=True, counter=True, kv_chunk=16),
}

# The same, on bf16 inputs (``chip_smoke.py`` phase ``ring_main`` runs the
# FLUX ring on the bf16 sequence too); the name ends in ``_bf16``.
BF16_VARIANTS = {
    "fused_counter_bf16": dict(fused=True, counter=True, kv_chunk=64),
}


def reset_launches():
    LAUNCHES.clear()
    CONTEXTS_LAUNCHED.clear()


def launches():
    """Kernel launches so far, all variants."""
    return sum(LAUNCHES.values())


def schedule_for(n, Sl, *, fused=False, kv_chunk=None):
    """The rotation schedule a call runs: ``kv_chunk`` (64 when fused and
    unset, the whole shard when neither) sanitized to a divisor of Sl, as
    the reference's ``ring_attention`` builds it."""
    return make_ring_schedule(n, Sl, kv_chunk or (DEFAULT_CHUNK if fused
                                                  else Sl), fused)


def variant_name(*, fused=False, counter=False, pipelined=True,
                 eager_wait=False, kv_chunk=None, causal=True, n, Sl,
                 dtype=torch.float32):
    """The variant a call launches: the realization, plus ``_kc<rows>``
    for a fused chunk other than 64 rows (after sanitizing against Sl),
    ``_full`` without the causal mask and ``_bf16`` on bf16 inputs."""
    if fused:
        name = "fused_counter" if counter else "fused_signal"
        kc = schedule_for(n, Sl, fused=True, kv_chunk=kv_chunk).kv_chunk
        if kc != DEFAULT_CHUNK:
            name += f"_kc{kc}"
    elif not pipelined:
        name = "deferred"
    else:
        name = "eager" if eager_wait else "pipelined"
    return name + ("" if causal else "_full") \
        + ("_bf16" if dtype == torch.bfloat16 else "")


def ring_work(n, BH, Sl, causal=True):
    """Each rank's work as the kernel computes it: the (64-row query tile,
    64-row key tile) pairs its pieces attend over all n steps, times BH. A
    tile the mask skips counts 0 and a ragged edge a whole tile: under the
    causal mask rank r attends to r whole shards (nqt^2 pairs each) and
    its own diagonal (nqt (nqt + 1) / 2); without it to n shards."""
    nqt = -(-int(Sl) // TILE)
    if causal:
        return [BH * (r * nqt * nqt + nqt * (nqt + 1) // 2) for r in range(n)]
    return [BH * n * nqt * nqt] * n


def ring_makespan(ctas, n, BH, Sl, causal=True):
    """The kernel's time on a split ``ctas``, in tile pairs of one CTA, as
    its protocol orders each rank's steps. A CTA runs whole pieces (a
    64-row query tile of one bh over all n steps), so in step s rank r's
    busiest CTA attends ceil(P / c_r) pieces of the shard that started on
    rank (r - s) % n: a whole one (nqt tiles a piece), its own diagonal
    ((nqt + 1) / 2) or, under the mask, none. A rank starts step s when it
    has finished step s - 1 and, from step 2, when the next rank has (the
    free-slot credit: its forward writes the slot that rank read then);
    it ends step s when the next step's shard has landed, forwarded by
    rank r - 1 as that rank started step s. The copies themselves count
    nothing: weighted by the data sheet's rates (a 64-row K and V tile
    against a tile pair) they took CTAs from the busiest rank and the ring
    ran slower on an H100."""
    nqt = -(-int(Sl) // TILE)
    pieces = BH * nqt
    end = [0.0] * n
    for s in range(n):
        start = [max(end[r], end[(r + 1) % n] if s >= 2 else 0.0)
                 for r in range(n)]
        for r in range(n):
            src = (r - s) % n
            tiles = nqt if not causal or src < r else \
                (nqt + 1) / 2 if src == r else 0
            done = start[r] + -(-pieces // ctas[r]) * tiles
            end[r] = max(done, start[(r - 1) % n]) if s <= n - 2 else done
    return max(end)


def ring_ctas(grid, n, BH, Sl, causal=True):
    """Each rank's CTAs of a launch of ``grid``, split by causal work: the
    split of the grid with the least :func:`ring_makespan` (whole pieces,
    the credit and arrival waits between ranks), found by moving CTAs
    between ranks from the split in proportion to each rank's attention
    (:func:`ring_work`) and from the even split. Every rank keeps one CTA
    at least; under the mask the counts never fall with r, and without it
    the ranks are alike and the split is even (within one). Raises where
    the grid cannot give every rank one CTA."""
    grid, n = int(grid), int(n)
    if grid < n:
        raise ValueError(f"a grid of {grid} CTAs cannot give {n} ranks one "
                         "each")
    return list(_best_split(grid, n, int(BH), int(Sl), bool(causal)))


@functools.lru_cache(maxsize=256)   # a launch asks once per shape
def _best_split(grid, n, BH, Sl, causal):
    def descend(best):
        cost = ring_makespan(tuple(best), n, BH, Sl, causal)
        step = max(1, grid // 8)
        while step:
            moved = False
            for i, j in itertools.permutations(range(n), 2):
                trial = list(best)
                trial[i] -= step
                trial[j] += step
                if trial[i] < 1 or (causal and trial != sorted(trial)):
                    continue
                c = ring_makespan(tuple(trial), n, BH, Sl, causal)
                if c < cost - 1e-9:
                    best, cost, moved = trial, c, True
            if not moved:
                step //= 2
        return cost, best

    even = cta_split(grid, [1] * n)[::-1]   # spare CTAs to the later ranks
    return tuple(min(descend(cta_split(grid, ring_work(n, BH, Sl, causal))),
                     descend(even))[1])


def _shape(q, k, v, contexts):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_attention wants q, k, v (n, BH, Sl, hd) "
                         f"alike; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    window.check_contexts(contexts)
    return tuple(q.shape)


# ------------------------------------------------------------ plain version


def ring_attention_plain(q, k, v, *, causal=True, kv_chunk=None, fused=False,
                         counter=False, pipelined=True, eager_wait=False,
                         contexts=2):
    """Plain-torch version on the stacked layout: in step s every rank r
    folds the shard that started on rank (r - s) % n into its online
    softmax, ``kv_chunk`` rows at a time (sanitized as the reference does),
    masked scores -1e30, the result acc / max(l, 1e-30) in q's dtype. The
    completion knobs change when chunks move, never what is attended, so
    they are only checked here."""
    n, BH, Sl, hd = _shape(q, k, v, contexts)
    cr = schedule_for(n, Sl, fused=fused, kv_chunk=kv_chunk).kv_chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32)
    acc = torch.zeros((n, BH, Sl, hd), dtype=torch.float32, device=dev)
    m = torch.full((n, BH, Sl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((n, BH, Sl), dtype=torch.float32, device=dev)
    ranks = torch.arange(n, device=dev)
    qpos = (ranks[:, None] * Sl + torch.arange(Sl, device=dev))[:, None, :,
                                                                None]
    for s in range(n):
        # rank r holds the shard of rank (r - s) % n
        ks, vs = torch.roll(k, s, dims=0), torch.roll(v, s, dims=0)
        src = (ranks - s) % n
        for c0 in range(0, Sl, cr):
            kc = ks[:, :, c0:c0 + cr].to(torch.float32)
            vc = vs[:, :, c0:c0 + cr].to(torch.float32)
            sc = torch.einsum("nbqd,nbkd->nbqk", qf, kc) * scale
            if causal:
                kpos = (src[:, None] * Sl + c0
                        + torch.arange(cr, device=dev))[:, None, None, :]
                sc = torch.where(qpos >= kpos, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=3))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=3)
            acc = acc * alpha[..., None] + torch.einsum("nbqk,nbkd->nbqd",
                                                        p, vc)
            m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


# ------------------------------------------------------------ the kernel


class _Params(ctypes.Structure):
    """``RingParams`` of ``csrc/ring_attention.cu``, field for field."""
    _fields_ = (
        [(k, ctypes.c_int) for k in (
            "n", "BH", "Sl", "hd", "chunk_rows", "nc", "fused", "counter",
            "pipelined", "eager", "causal", "bf16")]
        + [("cta0", ctypes.c_int * (MAX_RANKS + 1))]
        + [(k, ctypes.c_int) for k in ("timeout_ms", "stall_rank",
                                       "stall_us", "contexts", "log_cap")]
        + [("scale", ctypes.c_float)]
        + [(k, ctypes.c_void_p) for k in ("q", "k", "v", "out", "acc", "kbuf",
                                          "vbuf", "ml", "flag", "done", "log",
                                          "log_n")])


def _defines(test_stall=False, probe=False):
    return (STALL_DEFINES if test_stall else ()) \
        + (window.PROBE_DEFINES if probe else ())


def load_kernel(test_stall=False, probe=False):
    """Build (if needed) and load the kernel without running it — the
    fast path's stage A and the cascade's l1. ``test_stall``: the build
    with ``-DRING_TEST_STALL``, which honours ``stall_rank`` /
    ``stall_us`` (:func:`slowed_ring_attention`); ``probe``: the build
    with ``-DCUCO_PROBE``, which logs its window (:func:`check_log`)."""
    return build.load_typed("ring_attention", _Params, grid_args=3,
                            defines=_defines(test_stall, probe))


def grid_for(device, n, hd=64, test_stall=False, dtype=torch.float32,
             probe=False):
    """The co-resident grid the launch uses for ``n`` ranks at head
    dimension ``hd`` in ``dtype``: CTAs per SM x SMs, split over the ranks
    by :func:`ring_ctas`."""
    return build.grid(load_kernel(test_stall, probe), device, int(n),
                      int(hd), int(dtype == torch.bfloat16))


def log_cap(n, nc):
    """Events one CTA logs at most: a push, a retire and a receive wait a
    round, a drain a step, and room to spare."""
    return 3 * max(n - 1, 1) * nc + 2 * n + 8


def _launch(q, k, v, *, causal, kv_chunk, fused, counter, pipelined,
            eager_wait, contexts, stall, probe=None):
    """Launch the kernel; returns (out, the per-rank ``done`` counters,
    which end at each rank's CTA count times max(n - 2, 0)). ``probe``, a
    dict: launch the probe build and put its
    :class:`~repro_torch.kernels.window.DeviceLog` and CTA table there."""
    n, BH, Sl, hd = _shape(q, k, v, contexts)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ring_attention's kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() \
                or t.dtype != q.dtype or t.data_ptr() % 16:
            raise ValueError(f"ring_attention wants contiguous, 16-byte "
                             f"aligned tensors of q's dtype ({q.dtype}) on "
                             f"{q.device}; got {t.dtype} on {t.device}")
    per = 16 // q.element_size()           # elements in 16 bytes
    if hd > MAX_HD or hd % per:
        raise ValueError(f"ring_attention's kernel takes hd <= {MAX_HD}, a "
                         f"multiple of {per} in {q.dtype}; got {hd}")
    if n > MAX_RANKS:
        raise ValueError(f"ring_attention's kernel runs 1..{MAX_RANKS} "
                         f"ranks, got {n}")
    sched = schedule_for(n, Sl, fused=fused, kv_chunk=kv_chunk)
    chunk_rows = sched.kv_chunk if fused else Sl
    if 2 * BH * chunk_rows * hd >= 2**32:
        raise ValueError(f"a chunk of {BH} x {chunk_rows} x {hd} overflows "
                         "its 32-bit flag")
    grid, _ = grid_for(q.device, n, hd, test_stall=stall is not None,
                       dtype=q.dtype, probe=probe is not None)
    cta0 = list(itertools.accumulate(ring_ctas(grid, n, BH, Sl, causal),
                                     initial=0))
    nc = Sl // chunk_rows
    out = torch.empty_like(q)
    # the f32 accumulators park in out itself; a bf16 out cannot hold them
    acc = out if q.dtype == torch.float32 else torch.empty(
        q.shape, dtype=torch.float32, device=q.device)
    kbuf = torch.empty((n, 2, BH, Sl, hd), dtype=q.dtype, device=q.device)
    vbuf = torch.empty_like(kbuf)
    ml = torch.empty((2, n, BH, Sl), dtype=torch.float32, device=q.device)
    flags = torch.zeros(n * n * nc + n, dtype=torch.int32, device=q.device)
    stall_rank, stall_us = stall or (-1, 0)
    log = window.DeviceLog.alloc(grid if probe is not None else 1,
                                 log_cap(n, nc) if probe is not None else 1,
                                 q.device)
    p = _Params(n=n, BH=BH, Sl=Sl, hd=hd, chunk_rows=chunk_rows, nc=nc,
                fused=int(fused), counter=int(counter and fused),
                pipelined=int(pipelined), eager=int(eager_wait),
                causal=int(causal), bf16=int(q.dtype == torch.bfloat16),
                cta0=(ctypes.c_int * (MAX_RANKS + 1))(*cta0),
                timeout_ms=TIMEOUT_MS, stall_rank=int(stall_rank),
                stall_us=int(stall_us), scale=1.0 / math.sqrt(hd),
                q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                out=out.data_ptr(), acc=acc.data_ptr(), kbuf=kbuf.data_ptr(),
                vbuf=vbuf.data_ptr(), ml=ml.data_ptr(),
                flag=flags.data_ptr(), done=flags[n * n * nc:].data_ptr(),
                contexts=int(contexts), **log.params())
    build.launch(load_kernel(stall is not None, probe is not None), p,
                 q.device, grid)
    if probe is not None:   # not a launch of the counted paths
        probe.update(log=log, cta0=cta0)
        return out, flags[n * n * nc:]
    CONTEXTS_LAUNCHED[int(contexts)] += 1
    LAUNCHES[(variant_name(fused=fused, counter=counter, pipelined=pipelined,
                           eager_wait=eager_wait, kv_chunk=kv_chunk,
                           causal=causal, n=n, Sl=Sl, dtype=q.dtype), n, BH,
              Sl, hd)] += 1
    # the buffers and flags are freed here; the caching allocator reuses
    # them only in this stream's order, after the launch
    return out, flags[n * n * nc:]


def ring_attention(q, k, v, mesh=None, *, axis="x", causal=True,
                   kv_chunk=None, fused=False, counter=False, pipelined=True,
                   eager_wait=False, contexts=2):
    """Global entry, the JAX package's layout: q/k/v (n, BH, Sl, hd), rank
    r's shards in row r. ``fused`` + ``counter`` selects the chunk-rotating
    FLUX-ring path (``kv_chunk`` rows per chunk, sanitized to a divisor of
    Sl). ``mesh`` (a ``VirtualMesh``) is only checked: its rank count must
    be n."""
    del axis
    if mesh is not None and mesh.n != q.shape[0]:
        raise ValueError(f"a mesh of {mesh.n} ranks cannot take "
                         f"{q.shape[0]} shards")
    if q.device.type == "cpu":
        return ring_attention_plain(q, k, v, causal=causal,
                                    kv_chunk=kv_chunk, fused=fused,
                                    counter=counter, pipelined=pipelined,
                                    eager_wait=eager_wait, contexts=contexts)
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal=causal, kv_chunk=kv_chunk, fused=fused,
                   counter=counter, pipelined=pipelined,
                   eager_wait=eager_wait, contexts=contexts, stall=None)[0]


def slowed_ring_attention(q, k, v, *, rank, us, **knobs):
    """The kernel's test build on CUDA tensors: ``rank``'s CTAs idle
    ``us`` microseconds before each step's attention, so its upstream rank
    runs ahead and only the free-slot credit keeps it from overwriting a
    slot still being read. Takes :func:`ring_attention`'s knobs."""
    if q.device.type != "cuda":
        raise ValueError(f"the slowed ring is a kernel build; {q.device} "
                         "has none")
    knobs = dict(dict(causal=True, kv_chunk=None, fused=False, counter=False,
                      pipelined=True, eager_wait=False, contexts=2), **knobs)
    return _launch(q, k, v, stall=(int(rank), int(us)), **knobs)[0]


def ring_attention_logged(q, k, v, *, contexts=2, **knobs):
    """The probe build (``-DCUCO_PROBE``) on CUDA tensors at the full grid:
    ``(out, events, cta0)``, ``events`` each CTA's decoded window log
    (:func:`repro_torch.kernels.window.decode`) and ``cta0`` the ranks'
    CTA table. Takes :func:`ring_attention`'s knobs; not counted in
    ``LAUNCHES``."""
    if q.device.type != "cuda":
        raise ValueError(f"the probe build is a kernel build; {q.device} "
                         "has none")
    knobs = dict(dict(causal=True, kv_chunk=None, fused=False, counter=False,
                      pipelined=True, eager_wait=False), **knobs)
    probe = {}
    out, _ = _launch(q, k, v, contexts=contexts, stall=None, probe=probe,
                     **knobs)
    log = probe["log"]
    return out, window.decode(log.events, log.counts), probe["cta0"]


def check_log(events, cta0, *, n, Sl, contexts, fused=False, kv_chunk=None,
              **_):
    """Hold a probe launch's log to the window contract and to
    ``RingSchedule``: every CTA of a rank pushes each ``(step, chunk)``
    round of the schedule in its order (its share of every chunk, empty
    or not), drains at each of the n step boundaries, and waits on every
    chunk flag (``completion_ticks`` each). Returns the
    :func:`~repro_torch.kernels.window.summary` of the CTAs."""
    sched = schedule_for(n, Sl, fused=fused, kv_chunk=kv_chunk)
    rounds = sched.rounds
    stats = []
    for r in range(n):
        ctas = events[cta0[r]:cta0[r + 1]]
        for i, evs in enumerate(ctas):
            where = f"ring rank {r} CTA {i}: "
            st = window.check_cta(evs, contexts, rounds, where)
            if window.pushed(evs) != rounds or st["drains"] != n:
                raise window.WindowLogError(
                    f"{where}pushed {st['rounds']} rounds and {st['drains']} "
                    f"drains, not the schedule's {len(rounds)} and {n}")
            stats.append(st)
        window.check_rank(ctas, rounds, sched.completion_ticks(),
                          per_cta_ticks=True, where=f"ring rank {r}: ")
    return window.summary(stats)
