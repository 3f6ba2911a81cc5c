"""Structured cascade telemetry (port of ``repro/core/telemetry.py``).

* :func:`wallclock_us` — the one warm-then-timed wall-clock helper. On a
  CUDA device it times with ``torch.cuda.Event`` after a warm-up call and
  a synchronize; on the CPU it uses the host clock (the cascade's record
  names which).
* :class:`EvalRecord` — one structured row per evaluated candidate, JSON
  round-trippable (non-finite floats map to ``null``), naming the device
  the candidate ran on.
* :class:`MetricsRegistry` — counters / gauges / histograms with a JSON
  snapshot.

``SearchTelemetry`` (the slow path's aggregation) waits for the slow path.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field

import torch

__all__ = ["wallclock_us", "EvalRecord", "MetricsRegistry"]


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
