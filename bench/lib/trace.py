"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer metrics read.

The profiler starts after the warm-up and stops after the window's final
synchronize, so every device operation it records belongs to the window.
Device operations (kernels, copies, fills) come from CUPTI through the
profiler's event list; host spans are the benchmark's own ``bench.*``
ranges (``record_function``), on the same clock.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TOP = 10


@dataclass
class Trace:
    ops: list = field(default_factory=list)     # (name, start_ns, dur_ns)
    spans: list = field(default_factory=list)   # (name, start_ns, end_ns)
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)    # (span open, seconds)

    def kernel_ns(self, kernel):
        """Device time of the operations named ``kernel`` and their count."""
        pat = kernel_pattern(kernel)
        durs = [d for name, _, d in self.ops if pat.search(name)]
        return sum(durs), len(durs)

    def device_ns(self):
        return sum(d for _, _, d in self.ops)

    def top_ops(self):
        by = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, ns / 1e9] for name, ns in top]

    def top_gaps(self):
        return [[name, s] for name, s in
                sorted(self.gaps, key=lambda g: -g[1])[:TOP]]


def kernel_pattern(kernel):
    """A kernel's trace names: ``moe_kernel(MoeParams)``, ``void
    kv_shuttle_kernel<false>(ShuttleParams)``, the bare name."""
    return re.compile(r"(^|[\s:])" + re.escape(kernel) + r"($|[\s(<])")


@contextlib.contextmanager
def traced(enabled, device):
    """``(profiler or None, span)``: the profiler over the block when
    ``enabled``, and the span opener the window uses."""
    if not enabled:
        yield None, None
        return
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof, record_function


def _is_device(ev):
    """A kernel, copy or fill on the device: not the device's copy of a
    benchmark span (``bench.*``), which spans the kernels it launched."""
    return (str(ev.device_type()).split(".")[-1] != "CPU"
            and not ev.name().startswith("bench."))


def reduce(prof):
    """The profiler's events as a :class:`Trace`: device operations, the
    benchmark's spans, the union of device busy time, and each idle gap
    between device operations named by the span open on the host at its
    middle."""
    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        name, t, dur = ev.name(), ev.start_ns(), ev.duration_ns()
        if _is_device(ev):
            tr.ops.append((name, t, dur))
        elif name.startswith("bench."):
            tr.spans.append((name, t, t + dur))
    busy, end = 0, None
    gaps = []
    for _, t, d in sorted(tr.ops, key=lambda o: o[1]):
        if end is None or t > end:
            if end is not None:
                gaps.append((end, t))
            busy += d
            end = t + d
        elif t + d > end:
            busy += t + d - end
            end = t + d
    tr.busy_s = busy / 1e9
    tr.spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in tr.spans]
    for g0, g1 in gaps:               # the spans follow one another
        mid = (g0 + g1) // 2
        k = bisect.bisect_right(starts, mid) - 1
        name = tr.spans[k][0] if k >= 0 and mid < tr.spans[k][2] \
            else "no bench span"
        tr.gaps.append((name, (g1 - g0) / 1e9))
    return tr
