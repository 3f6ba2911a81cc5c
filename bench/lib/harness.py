"""One run of one cell: set-up, the measured window, the traced reading,
the check against the plain reference, and the result line.

:func:`run_cell` takes the device it is given; ``bench/run.py`` gives it
the card after checking there is one, and the CPU tests give it the CPU
at a tiny size to drive the same path.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from bench.counts import peaks
from bench.lib import guard, spec as speclib, trace as tracelib, traffic
from bench.lib import window as windowlib

@dataclass
class Context:
    """What a metric reader reads."""
    layer: object
    window: windowlib.Window
    setup_s: float
    peak_bytes: int
    trace: tracelib.Trace | None = None

    def bound_s(self, j):
        """Pool entry j's least time on the card (``counts.peaks``)."""
        return peaks.bound_s(self.layer.flops(j), self.layer.nbytes(j),
                             self.layer.dtype)

    def flops_peak(self):
        return peaks.FLOPS[self.layer.dtype]

    def launches(self):
        """Launches of the layer's kernel over the window's steps: the
        layer's ``launches(j)`` for a step on pool entry j, where it states
        one, else one a step."""
        per = getattr(self.layer, "launches", None)
        if per is None:
            return len(self.window.entries)
        return sum(per(j) for j in self.window.entries)

    def roofline(self, kernel):
        """The share (%) of its roofline that the device time of
        ``kernel`` reaches over the window: every step's least time
        (:meth:`bound_s`) over the kernel's summed time in the trace;
        None without a trace or unless the trace holds as many launches
        as the steps make (:meth:`launches`)."""
        if self.trace is None:
            return None
        ns, launches = self.trace.kernel_ns(kernel)
        if not ns or launches != self.launches():
            return None
        bound = sum(self.bound_s(j) for j in self.window.entries)
        return 100.0 * bound / (ns / 1e9)


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True)
        return float(got.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(device, count, peak_bytes, tr, win):
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": count, "memory_peak_bytes": peak_bytes}
    if dev.type == "cuda":
        info["power_limit_w"] = power_limit()
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = win.wall_s
    return info


def run_cell(root, name, seed, seconds, trace, device, t_start,
             out=sys.stdout, err=sys.stderr):
    """Run cell ``name`` of the checkout at ``root`` once; print the
    result line on ``out`` and return 0, or return a code other than 0
    and print no result."""
    phases = [("imports", time.perf_counter())]
    spec = speclib.Spec(root)
    cell = spec.cell(name)
    config, mix, checks = spec.config(cell), spec.traffic(cell), \
        spec.checks(cell)
    entries = traffic.pool(mix, seed)
    layer = speclib.module("layers", config["layer"]).Layer(
        config, mix, entries, seed, device)
    clock = windowlib.clock_for(device)
    cuda = torch.device(device).type == "cuda"
    clock.sync()
    phases.append(("data and builds", time.perf_counter()))
    # every shape twice, the first pass's outputs held while the second
    # runs and drops each of its own, as the window holds one output of
    # each entry while it runs the next: the caching allocator then has
    # every block the window asks for, and no more
    held = [step() for step in layer.steps]
    for step in layer.steps:
        step()
    clock.sync()
    del held
    phases.append(("warm-up (first launch loads or builds)",
                   time.perf_counter()))
    sample = traffic.Reservoir(seed)
    with tracelib.traced(trace, device) as (prof, span):
        setup_s = time.perf_counter() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        win = windowlib.run(layer.steps, seconds, clock, sample, span)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = tracelib.reduce(prof) if prof is not None else None

    # the program's state goes before the reference runs on the card
    layer.steps = []
    if cuda:
        torch.cuda.empty_cache()
    worst = {k: 0.0 for k in checks}
    failed = 0
    for _, j, got in sample.items():
        nums = layer.check(j, got)
        bad = False
        for k, lim in checks.items():
            v = nums[k]
            worst[k] = max(worst[k], v) if math.isfinite(v) else math.inf
            bad |= not v <= lim["limit"]
        failed += bad
    correct = len(sample.kept) == len(entries) and failed == 0
    ctx = Context(layer, win, setup_s, peak, tr)
    wanted = spec.per_layer(cell) if trace else spec.end_to_end(cell)
    metrics = {}
    for m in wanted:
        v = spec.metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    found = guard.forbidden_loaded()
    if found:
        print(f"bench: forbidden modules loaded: {', '.join(found)}",
              file=err)
        return 3
    check = {k: {"value": worst[k], "limit": checks[k]["limit"]}
             for k in checks}
    result = {"correct": correct, "attempted": len(win.entries),
              "failed": failed, "metrics": metrics,
              "device": device_info(device, cell["chips"], peak, tr, win)}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.top_gaps()}
    result["check"] = check
    starts = [t_start] + [t for _, t in phases]
    print("setup " + ", ".join(f"{what} {t - t0:.3f} s" for (what, t), t0
                               in zip(phases, starts)), file=out)
    print(f"steps {len(win.entries)}, checked {len(sample.kept)} "
          f"(steps {[s for s, _, _ in sample.items()]}), "
          f"window {win.wall_s!r} s", file=out)
    for k, c in check.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
