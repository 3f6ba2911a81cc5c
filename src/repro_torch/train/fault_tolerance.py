"""Fault tolerance & elasticity (port of ``repro/train/fault_tolerance.py``).

Mechanisms:

* **Preemption-aware saving** — SIGTERM/SIGINT installs a "save at the
  next step boundary" flag (:class:`PreemptionGuard`), which the training
  loop (``train/loop.py``) honours by checkpointing and returning.
* **Straggler mitigation** — synchronous steps cannot proceed without
  every worker; the watchdog measures per-step wall time against a rolling
  median and flags persistent stragglers for replacement
  (:class:`StragglerWatchdog`).
* **Elastic re-mesh** — :class:`ElasticController` drops a rank whose
  watchdog trips and maps any collective schedule or workload onto the
  survivors (``degrade(live_ranks)``); the serving engine shrinks with it
  (``serve/engine.py::Engine.degrade``).
"""
from __future__ import annotations

import signal
import statistics
from dataclasses import dataclass, field


class PreemptionGuard:
    """Installs signal handlers that request a graceful save+exit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


@dataclass
class StragglerWatchdog:
    """Rolling-median step-time monitor. A worker consistently slower than
    ``threshold`` x median is reported as a straggler.

    ``record`` accepts the round's tick count from the collective
    schedules (``issued_rounds()`` / ``completion_ticks()``): wall time is
    normalized to per-tick before the median compare, so a structurally
    bigger round (more DMA events) is never mistaken for a slower rank.

    Incidents live in a sliding window of the last ``incident_window``
    records — blips age out instead of latching forever, and
    ``should_replace`` asks for ``replace_after`` incidents *within the
    window*: a persistent straggler keeps it armed, transient jitter
    decays back to healthy. ``reset()`` clears the history after a
    replacement so the substitute rank starts clean."""
    window: int = 32
    threshold: float = 2.0
    min_samples: int = 8
    incident_window: int = 16
    replace_after: int = 3
    times: list = field(default_factory=list)
    incidents: int = 0            # lifetime total (monotonic, diagnostics)
    _step: int = 0
    _incident_steps: list = field(default_factory=list)

    def record(self, step_time_s: float, ticks: int = 1) -> bool:
        """Returns True if this step is a straggler incident."""
        t = float(step_time_s) / max(1, int(ticks))
        self._step += 1
        self._prune()
        self.times.append(t)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < self.min_samples:
            return False
        med = statistics.median(self.times[:-1])
        if t > self.threshold * med:
            self.incidents += 1
            self._incident_steps.append(self._step)
            return True
        return False

    def _prune(self):
        horizon = self._step - self.incident_window
        while self._incident_steps and self._incident_steps[0] <= horizon:
            self._incident_steps.pop(0)

    @property
    def recent_incidents(self):
        """Incidents still inside the sliding window."""
        self._prune()
        return len(self._incident_steps)

    @property
    def should_replace(self):
        return self.recent_incidents >= self.replace_after

    def reset(self):
        """Post-replacement: the substitute rank starts with no history."""
        self.times.clear()
        self._incident_steps.clear()
        self.incidents = 0
        self._step = 0


@dataclass
class ElasticController:
    """Closes the fault loop across train/serve and the collective
    kernels: one :class:`StragglerWatchdog` per rank consumes per-round
    tick accounting from the schedules, a rank whose watchdog trips is
    dropped from the live set, and :meth:`degrade` maps any
    ``CollectiveSchedule`` (or workload) onto the survivors — drop the
    rank, degrade the schedules, keep serving.

    Fleet health is exported through ``metrics`` (a
    ``core.telemetry.MetricsRegistry``, one created per controller
    otherwise): straggler-incident and dropped-rank counters, a
    ``elastic.live_ranks`` gauge, per-rank step-time histograms, and a
    degrade-event counter — ``controller.metrics.snapshot()`` is the
    JSON-ready fleet view."""
    n_ranks: int
    window: int = 32
    threshold: float = 2.0
    min_samples: int = 8
    incident_window: int = 16
    replace_after: int = 3
    metrics: object = None

    def __post_init__(self):
        if self.metrics is None:
            from repro_torch.core.telemetry import MetricsRegistry
            self.metrics = MetricsRegistry()
        self._live = list(range(self.n_ranks))
        self.watchdogs = {
            r: StragglerWatchdog(
                window=self.window, threshold=self.threshold,
                min_samples=self.min_samples,
                incident_window=self.incident_window,
                replace_after=self.replace_after)
            for r in self._live}
        self.metrics.gauge("elastic.live_ranks").set(len(self._live))

    @property
    def live_ranks(self):
        return tuple(self._live)

    def observe_round(self, times_by_rank, ticks: int = 1):
        """Feed one collective round's per-rank wall times (seconds);
        ``ticks`` is the round's event count from the schedule. Returns
        the ranks dropped by this observation (usually empty)."""
        dropped = []
        for r in sorted(times_by_rank):
            if r not in self._live:
                continue
            self.metrics.histogram("elastic.step_ms").observe(
                float(times_by_rank[r]) * 1e3)
            if self.watchdogs[r].record(times_by_rank[r], ticks=ticks):
                self.metrics.counter("elastic.straggler_incidents").inc()
            if self.watchdogs[r].should_replace:
                self.drop(r)
                dropped.append(r)
        return tuple(dropped)

    def drop(self, rank):
        """Remove ``rank`` from the membership (idempotent); refuses to
        drop the last survivor — a collective needs one."""
        if rank in self._live:
            if len(self._live) == 1:
                raise RuntimeError("cannot drop the last live rank")
            self._live.remove(rank)
            self.watchdogs[rank].reset()
            self.metrics.counter("elastic.ranks_dropped").inc()
            self.metrics.gauge("elastic.live_ranks").set(len(self._live))

    def degrade(self, schedule_or_workload):
        """Map a ``CollectiveSchedule`` (or a ``Workload``) onto the
        current live set via its ``degrade(live_ranks)`` contract."""
        self.metrics.counter("elastic.degrade_events").inc()
        return schedule_or_workload.degrade(self.live_ranks)
