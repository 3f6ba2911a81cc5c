"""Structured cascade telemetry (port of ``repro/core/telemetry.py``).

* :func:`wallclock_us` — the one warm-then-timed wall-clock helper. On a
  CUDA device it times with ``torch.cuda.Event`` after a warm-up call and
  a synchronize; on the CPU it uses the host clock (the cascade's record
  names which).
* :class:`EvalRecord` — one structured row per evaluated candidate, JSON
  round-trippable (non-finite floats map to ``null``), naming the device
  the candidate ran on.
* :class:`SearchTelemetry` — aggregates the records of one ``slow_path``
  run into per-generation / per-island series and mutation win rates; its
  ``payload()`` is the reference's ``BENCH_search.json`` JSON for the same
  records (wall-clock fields stay out).
* :class:`MetricsRegistry` — counters / gauges / histograms with a JSON
  snapshot.
* :func:`span`, :data:`TRACE`, :func:`kernel_counters`, :func:`note`,
  :func:`collect`, :func:`spans`, :func:`notes` — the program's own
  trace: host spans in the kernel wrappers, cycle counters inside the
  kernels and the host's counts of each launch, on exactly while a
  ``torch.profiler`` records (``src/repro_torch/OBSERVABILITY.md``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import time
from dataclasses import dataclass, field, replace

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["wallclock_us", "EvalRecord", "SearchTelemetry",
           "MetricsRegistry", "TRACE", "span", "spans", "kernel_counters",
           "note", "notes", "collect", "cycle_share", "reset"]


def wallclock_us(fn, inputs, iters=3):
    """Mean time of ``fn(*inputs)`` over ``iters`` calls, in microseconds,
    after one warm-up call, on the device of the first input. On a CUDA
    device the calls are bracketed by CUDA events after a synchronize, so
    the number is device time of the whole call sequence; on the CPU the
    host clock times the calls."""
    device = inputs[0].device
    fn(*inputs)                                     # build + warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*inputs)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*inputs)
    return (time.perf_counter() - t0) / iters * 1e6


def _jsonable(x):
    """None-preserving float for JSON: non-finite -> None (exact
    round-trip; JSON has no inf/nan)."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


@dataclass
class EvalRecord:
    """One candidate's structured evaluation row.

    ``levels_s`` maps cascade level name ("l0", "l1", "l2", "l3",
    "wallclock") to the wall seconds that level took; ``t_model_ms``/
    ``t_wall_ms`` are ``None`` (not inf) when the level was never
    reached. ``rejection`` is the deterministic rejection class ("" on
    success, "invalid", "l0:<checker code>", "l1:build", "l2:execute"/
    "l2:nonfinite"/"l2:mismatch", "quarantine", "error"); ``stage`` is the
    cascade level in flight when the record was cut. ``device`` names
    where l1–l3 ran (``cuda:0 (NVIDIA H100 ...)`` or ``cpu``)."""
    cid: int = -1
    gen: int = 0
    island: int = 0
    mutation: str = "seed"
    directive: str = ""
    level: int = 0
    score: float = 0.0
    t_model_ms: float | None = None
    t_wall_ms: float | None = None
    levels_s: dict = field(default_factory=dict)
    retries: int = 0
    quarantined: bool = False
    fault_penalty_ms: float = 0.0
    knobs: dict = field(default_factory=dict)
    diagnostic: str = ""
    elapsed_s: float = 0.0
    rejection: str = ""
    stage: str = ""
    device: str = ""

    def to_dict(self):
        return {
            "cid": int(self.cid), "gen": int(self.gen),
            "island": int(self.island), "mutation": str(self.mutation),
            "directive": str(self.directive), "level": int(self.level),
            "score": float(self.score),
            "t_model_ms": _jsonable(self.t_model_ms),
            "t_wall_ms": _jsonable(self.t_wall_ms),
            "levels_s": {k: float(v) for k, v in self.levels_s.items()},
            "retries": int(self.retries),
            "quarantined": bool(self.quarantined),
            "fault_penalty_ms": float(self.fault_penalty_ms),
            "knobs": dict(self.knobs),
            "diagnostic": str(self.diagnostic),
            "elapsed_s": float(self.elapsed_s),
            "rejection": str(self.rejection),
            "stage": str(self.stage),
            "device": str(self.device),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(**d)

    def to_json(self):
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s):
        return cls.from_dict(json.loads(s))

    def deterministic_dict(self):
        """The run-deterministic projection of the row: everything except
        the wall-clock fields (``levels_s``, ``elapsed_s``, ``t_wall_ms``)
        and ``stage``. Two evaluations of the same candidate must agree on
        this dict bit for bit."""
        d = self.to_dict()
        for k in ("levels_s", "elapsed_s", "t_wall_ms", "stage"):
            d.pop(k)
        return d


# ------------------------------------------------------------ search series


class SearchTelemetry:
    """Aggregates one search run's :class:`EvalRecord` stream.

    ``observe`` ingests records in evaluation order (the win-rate
    accounting is order-sensitive: a record *wins* when it strictly beats
    the best score seen before it); ``note_coverage`` stamps the archive
    coverage after a generation closes."""

    def __init__(self, workload=""):
        self.workload = str(workload)
        self.records = []
        self.coverage = {}           # gen -> archive cells occupied
        self._best = 0.0
        self._wins = {}              # mutation form -> win count
        # warm-start / transfer counters (docs/search.md). Deliberately
        # batch-invariant: the batched and sequential evaluators produce
        # byte-identical payloads, so batching stats stay OUT of here.
        self.scale = {"warm_start": False, "cache_hits": 0,
                      "transferred_seeds": 0}

    def note_scale(self, **kw):
        """Stamp warm-start/transfer counters onto the run (slow_path)."""
        for k, v in kw.items():
            self.scale[k] = v

    def observe(self, record: EvalRecord):
        self.records.append(record)
        if record.score > self._best:
            self._best = record.score
            self._wins[record.mutation] = \
                self._wins.get(record.mutation, 0) + 1

    def note_coverage(self, gen, coverage):
        self.coverage[int(gen)] = float(coverage)

    # ------------------------------------------------------------- series
    def generation_series(self):
        gens = sorted({r.gen for r in self.records})
        out = []
        for g in gens:
            rs = [r for r in self.records if r.gen == g]
            scored = [r.score for r in rs]
            out.append({
                "gen": g,
                "evals": len(rs),
                "best_score": max(scored),
                "mean_score": sum(scored) / len(scored),
                "ok": sum(1 for r in rs if r.level >= 3),
                "quarantined": sum(1 for r in rs if r.quarantined),
                "retries": sum(r.retries for r in rs),
                "archive_coverage": self.coverage.get(g),
            })
        return out

    def island_series(self):
        isls = sorted({r.island for r in self.records})
        out = []
        for i in isls:
            rs = [r for r in self.records if r.island == i]
            out.append({
                "island": i,
                "evals": len(rs),
                "best_score": max(r.score for r in rs),
                "mean_score": sum(r.score for r in rs) / len(rs),
                "quarantined": sum(1 for r in rs if r.quarantined),
            })
        return out

    def mutation_stats(self):
        """Per-mutation-operator attempt/success/win table. A *win* is a
        new global best at observe time — the cross-strategy signal the
        meta-summarizer coordinates on."""
        forms = sorted({r.mutation for r in self.records})
        out = []
        for f in forms:
            rs = [r for r in self.records if r.mutation == f]
            out.append({
                "mutation": f,
                "attempts": len(rs),
                "ok": sum(1 for r in rs if r.level >= 3),
                "wins": self._wins.get(f, 0),
                "win_rate": self._wins.get(f, 0) / len(rs),
            })
        return out

    # ------------------------------------------------------------ artifact
    def payload(self, meta=None):
        """The ``BENCH_search.json`` payload: deterministic aggregates
        only (wall-clock fields excluded — regenerating on any machine
        must be diff-stable for a checked-in artifact)."""
        best = max(self.records, key=lambda r: r.score, default=None)
        return {
            "schema": "bench-search/v2",
            "workload": self.workload,
            "meta": dict(meta or {}),
            "scale": {"warm_start": bool(self.scale["warm_start"]),
                      "cache_hits": int(self.scale["cache_hits"]),
                      "transferred_seeds":
                          int(self.scale["transferred_seeds"])},
            "totals": {
                "evals": len(self.records),
                "ok": sum(1 for r in self.records if r.level >= 3),
                "quarantined": sum(1 for r in self.records if r.quarantined),
                "retries": sum(r.retries for r in self.records),
                "best_score": self._best,
            },
            "best": None if best is None else {
                "cid": best.cid, "gen": best.gen, "island": best.island,
                "mutation": best.mutation, "directive": best.directive,
                "score": best.score, "t_model_ms": _jsonable(best.t_model_ms),
                "knobs": dict(best.knobs),
            },
            "generations": self.generation_series(),
            "islands": self.island_series(),
            "mutations": self.mutation_stats(),
        }

    def write(self, path, meta=None):
        with open(path, "w") as f:
            json.dump(self.payload(meta), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_candidates(cls, candidates, workload="", coverage=None):
        """Build telemetry from evaluated ``Candidate``s (the slow-path
        aggregation seam): candidates whose results carry an attached
        :class:`EvalRecord` contribute it; results from a custom evaluator
        without records are synthesized from the candidate itself."""
        tel = cls(workload)
        for c in candidates:
            rec = getattr(c.result, "record", None) if c.result else None
            if rec is None:
                res = c.result
                rec = EvalRecord(
                    cid=c.cid, gen=c.gen, island=c.island,
                    mutation=c.mutation, directive=repr(c.directive),
                    level=res.level if res else 0,
                    score=res.score if res else 0.0,
                    t_model_ms=_jsonable(res.t_model_ms) if res else None,
                    t_wall_ms=_jsonable(res.t_wall_ms) if res else None,
                    retries=res.retries if res else 0,
                    quarantined=bool(res and res.quarantined),
                    diagnostic=res.diagnostic if res else "never evaluated")
            else:
                rec = replace(rec)          # observe order owns win stats
            tel.observe(rec)
        for g, cov in (coverage or {}).items():
            tel.note_coverage(g, cov)
        return tel


# ----------------------------------------------------------------- metrics


class _Counter:
    def __init__(self):
        self.value = 0.0

    def inc(self, v=1.0):
        self.value += v


class _Gauge:
    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = float(v)


class _Histogram:
    """Stores observations and reports count/sum/mean and interpolated
    quantiles. ``max_samples`` bounds memory by decimation (keep every
    other sample once full)."""

    def __init__(self, max_samples=4096):
        self.samples = []
        self.count = 0
        self.total = 0.0
        self.max_samples = int(max_samples)

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.total += v
        self.samples.append(v)
        if len(self.samples) > self.max_samples:
            self.samples = self.samples[::2]

    def quantile(self, q):
        if not self.samples:
            return None
        s = sorted(self.samples)
        if len(s) == 1:
            return s[0]
        pos = (len(s) - 1) * min(1.0, max(0.0, float(q)))
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    def summary(self):
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else None,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "max": max(self.samples) if self.samples else None,
        }


class MetricsRegistry:
    """Minimal counter/gauge/histogram registry with a JSON snapshot.
    Instruments fetch-or-create by name."""

    def __init__(self):
        self._counters = {}
        self._gauges = {}
        self._histograms = {}

    def counter(self, name) -> _Counter:
        return self._counters.setdefault(str(name), _Counter())

    def gauge(self, name) -> _Gauge:
        return self._gauges.setdefault(str(name), _Gauge())

    def histogram(self, name, max_samples=4096) -> _Histogram:
        return self._histograms.setdefault(str(name),
                                           _Histogram(max_samples))

    def clear(self):
        for instruments in (self._counters, self._gauges, self._histograms):
            instruments.clear()

    def snapshot(self):
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }

    def to_json(self, indent=None):
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def write(self, path, indent=2):
        with open(path, "w") as f:
            f.write(self.to_json(indent=indent))
            f.write("\n")


# ----------------------------------------------------------- program trace
#
# Spans in the kernel wrappers and cycle counters in the kernels, on
# exactly while a torch.profiler records: an untraced call pays one C call
# a span (``torch.autograd._profiler_enabled``) and launches the production
# build of its kernel, which compiles no counter, with a null pointer.
# A span's times are ``time.time_ns()``, the clock the profiler stamps its
# host and device events on, so the log lines up with the profiler's
# kernels. One thread opens the spans (the wrappers are called from the
# launching thread).
#
# A span's range in the profiler is a function-scope range
# (``_RecordFunctionFast``), not ``record_function``'s user-scope one: the
# profiler gives a user-scope range a device-side copy spanning the
# kernels launched inside it, which a reader of the trace's device
# operations would count as device time; a function-scope range has
# none, and costs about 2 us where the other costs 15.
#
# Of a kernel's traced launches, every COUNT_EVERY-th (the first
# included) runs the counting build; the others run the production build,
# so that the profiler's kernel times stay the production kernel's. The
# stride is prime, so it meets every position of a loop over a pool of
# inputs whose size it does not divide.

SPAN_LOG_CAP = 1 << 18   # spans kept: the newest; a traced window holds fewer
COUNT_EVERY = 17
# a CTA role's counters, in the order of csrc/cta_stats.cuh's buckets
KERNEL_BUCKETS = ("ctas", "cycles", "wait", "gemm")

TRACE = MetricsRegistry()
# (name, call id, parent name, t0 ns, t1 ns)
_LOG = collections.deque(maxlen=SPAN_LOG_CAP)
_OPEN = []               # (name, call id) of the open spans, innermost last
_CALLS = itertools.count(1)
# (name, value, t ns): the host's counts of each launch (``note``)
_NOTES = collections.deque(maxlen=SPAN_LOG_CAP)
_KERNELS = {}            # (kernel, device) -> (roles, int64 (roles, buckets))
_TRACED = collections.Counter()   # (kernel, device) -> traced launches
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "call", "parent", "range", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        self.parent, self.call = _OPEN[-1] if _OPEN else (None,
                                                          next(_CALLS))
        _OPEN.append((self.name, self.call))
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _OPEN.pop()
        _LOG.append((self.name, self.call, self.parent, self.t0, t1))
        self.range.__exit__(*exc)
        return False


def span(name):
    """A context manager over a named piece of the program. While a
    ``torch.profiler`` records it opens a profiler range of that name (in
    the profiler's host timeline, nested in the ranges around it), appends
    ``(name, call id, parent, t0, t1)`` to the log (:func:`spans`; the
    spans under one outermost span share its call id, ``parent`` is the
    enclosing span's name); otherwise it does nothing."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name)


def spans():
    """The closed spans so far (the newest ``SPAN_LOG_CAP``), in the order
    they closed."""
    return list(_LOG)


def note(name, value):
    """A count the host knows of one launch (rows routed, say) under
    ``name``: kept with its time on the profiler's clock while a
    ``torch.profiler`` records (:func:`notes`); nothing otherwise."""
    if torch.autograd._profiler_enabled():
        _NOTES.append((name, float(value), time.time_ns()))


def notes():
    """The counts :func:`note` kept (the newest ``SPAN_LOG_CAP``), in the
    order they came: ``(name, value, t ns)``."""
    return list(_NOTES)


def kernel_counters(kernel, roles, device):
    """The accumulator a launch of ``kernel`` on ``device`` passes as its
    ``stats`` pointer, to the counting build (``kernels.build.
    STATS_DEFINES``), on every ``COUNT_EVERY``-th launch while a profiler
    records, the first included: int64 (len(roles), len(KERNEL_BUCKETS))
    on the device, zeroed once and kept for the process, to which each CTA
    of role r adds its counts at exit. None otherwise (the production
    build and a null pointer)."""
    if not torch.autograd._profiler_enabled():
        return None
    key = (kernel, torch.device(device))
    _TRACED[key] += 1
    if (_TRACED[key] - 1) % COUNT_EVERY:
        return None
    if key not in _KERNELS:
        _KERNELS[key] = (tuple(roles), torch.zeros(
            (len(roles), len(KERNEL_BUCKETS)), dtype=torch.int64,
            device=device))
    return _KERNELS[key][1]


def _counts():
    """Every kernel's device counters, ``<kernel>.<role>.<bucket>``
    summed over devices, with one synchronizing read a device."""
    got = {}
    for dev in {dev for _, dev in _KERNELS}:
        keys = [k for k in _KERNELS if k[1] == dev]
        vals = iter(torch.cat([_KERNELS[k][1].flatten()
                               for k in keys]).tolist())
        for kernel, _ in keys:
            for role in _KERNELS[(kernel, dev)][0]:
                for bucket in KERNEL_BUCKETS:
                    name = f"{kernel}.{role}.{bucket}"
                    got[name] = got.get(name, 0.0) + next(vals)
    return got


def collect():
    """TRACE made anew from the program's trace: a histogram of each
    span's durations (ms) from the log and of each :func:`note`'s values,
    one a launch, and the kernels' counters (``<kernel>.<role>.<bucket>``,
    summed over devices) with one synchronizing read a device; returns
    the kernels' counters as a dict."""
    TRACE.clear()
    for name, _, _, t0, t1 in _LOG:
        TRACE.histogram(name, SPAN_LOG_CAP).observe((t1 - t0) / 1e6)
    for name, value, _ in _NOTES:
        TRACE.histogram(name, SPAN_LOG_CAP).observe(value)
    got = _counts()
    for name, v in got.items():
        TRACE.counter(name).value = v
    return got


def cycle_share(kernel, bucket):
    """The share (%) of ``kernel``'s CTA cycles, every role together,
    counted in ``bucket`` (``"wait"`` or ``"gemm"``), from the counters
    :func:`collect` reads; None when no CTA of it was counted."""
    got = _counts()
    total = sum(v for k, v in got.items()
                if k.startswith(f"{kernel}.") and k.endswith(".cycles"))
    part = sum(v for k, v in got.items()
               if k.startswith(f"{kernel}.") and k.endswith(f".{bucket}"))
    return 100.0 * part / total if total else None


def reset():
    """Forget the log, the notes, TRACE's instruments and the kernels'
    counters and traced launches."""
    _LOG.clear()
    _NOTES.clear()
    TRACE.clear()
    _KERNELS.clear()
    _TRACED.clear()
