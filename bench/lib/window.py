"""The measured window: a closed loop of steps, back to back.

Step i calls ``steps[i % len(steps)]`` (one call of the program's layer on
one pool entry), then records a CUDA event on the launch stream. Nothing
synchronizes the device between steps: the host only waits for the event
of step ``i - depth`` before it enqueues step ``i + 1``, so it runs at
most ``depth`` steps ahead and the window's end is known on the host. The
loop stops enqueuing once ``seconds`` have passed on the host clock and
every pool entry has run, and the window closes with one synchronize. A
step's time is the interval between its event and the previous step's
(the first step's from an event recorded before it), so a stall or an
idle gap of the device counts.
"""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import torch

DEPTH = 3


class CudaClock:
    """Marks on the current CUDA stream."""

    def __init__(self, device):
        self.device = torch.device(device)

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def wait(ev):
        ev.synchronize()

    def sync(self):
        torch.cuda.synchronize(self.device)

    @staticmethod
    def ms(a, b):
        return a.elapsed_time(b)


class HostClock:
    """Marks on the host clock (CPU tensors run synchronously)."""

    def mark(self):
        return time.perf_counter_ns()

    @staticmethod
    def wait(ev):
        del ev

    def sync(self):
        pass

    @staticmethod
    def ms(a, b):
        return (b - a) / 1e6


def clock_for(device):
    return CudaClock(device) if torch.device(device).type == "cuda" \
        else HostClock()


@dataclass
class Window:
    entries: list = field(default_factory=list)   # pool entry of each step
    step_ms: list = field(default_factory=list)
    host_ns: list = field(default_factory=list)   # span of each call
    wall_s: float = 0.0


def run(steps, seconds, clock, sample, span=None):
    """Run the window; ``sample`` (a ``traffic.Reservoir``) is offered
    every step's output. ``span(name)`` opens a named host span (the
    profiler's, in a traced run)."""
    span = span or (lambda name: contextlib.nullcontext())
    # no collection of the interpreter's garbage inside the window: a full
    # one stalls the host for milliseconds, longer than the steps queued
    gc.collect()
    gc.disable()
    try:
        return _loop(steps, seconds, clock, sample, span)
    finally:
        gc.enable()


def _loop(steps, seconds, clock, sample, span):
    win = Window()
    marks = []
    n = len(steps)
    start = clock.mark()
    t0 = time.perf_counter()
    i = 0
    while True:
        j = i % n
        h0 = time.perf_counter_ns()
        with span("bench.step"):
            out = steps[j]()
        win.host_ns.append(time.perf_counter_ns() - h0)
        marks.append(clock.mark())
        win.entries.append(j)
        sample.offer(i, j, out)
        del out
        i += 1
        if i >= n and time.perf_counter() - t0 >= seconds:
            break
        if i >= DEPTH:
            with span("bench.wait"):
                clock.wait(marks[i - DEPTH])
    with span("bench.drain"):
        clock.sync()
    win.wall_s = time.perf_counter() - t0
    prev = start
    for m in marks:
        win.step_ms.append(clock.ms(prev, m))
        prev = m
    return win
