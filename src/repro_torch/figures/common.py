"""What the port's figures share (port of ``benchmarks/common.py``): the
modeled latency of a point, the ``bench-rows/v1`` writer (taken from
``repro_torch.suites.common``, not copied again), and the measurement of
one figure point on the device.

A figure's modeled rows are the reference's: each point's l3 cost on the
``ChipSpec`` a run is given, at the paper's shape. With ``measure=True``
each point the workload's ``check`` accepts also runs: built with
``workload.build(d, mesh)`` on a ``VirtualMesh`` of the workload's ranks
(a host directive builds the workload's ``host_baseline``), on inputs at
the figure's shape from a seeded ``torch.Generator``, held to the
workload's ``reference()`` and timed by :func:`point_us` (the median of
``iters`` calls, the L2 overwritten before each, with the least and the
most beside it). It adds a row named ``<modeled row>_card``.

On the card the n ranks are partitions of one GPU: a measured "speedup"
is one card holding every rank, with no link between the ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import statistics
import sys
import time

import torch

from repro_torch.compat import REPO_ROOT
from repro_torch.core.cascade import _full_f32
from repro_torch.core.hardware import H100, card_label
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.suites.common import (CHIPS, allclose, require,
                                       resolve_device, write_rows)
from repro_torch.workloads import get_workload

__all__ = ["FIGURES_DIR", "CHIPS", "modeled_ms", "write_rows",
           "resolve_device", "card_label", "measured_rows", "point_us",
           "interleave", "orderings", "parser", "main"]

# where the command lines write a figure's table unless given ``--out``
FIGURES_DIR = REPO_ROOT / "build" / "figures"
KERNEL_BACKENDS = ("PALLAS_RDMA", "HYBRID")
RTOL = 2e-3            # the cascade's rtol, elementwise as the workload suite
I8_TOL = 0.1           # the int8 wire, as the workload suite
SMALL_DIV = 64         # ``small``: every cut dimension over 64
SMALL_MIN = 8
# the dimensions ``small`` cuts, a workload each (ranks, skew and the head
# width stay: they name the point, not its size)
CUT = {"moe_dispatch": ("tokens_per_rank", "d", "f"),
       "kv_transfer": ("T", "d", "dk"),
       "gemm_allgather": ("M", "K", "N"),
       "ring_attention": ("BH", "seq")}
SCORE_BYTES = 2 ** 31  # the ring oracle's score block, at most
FLUSH_WORDS = 2 ** 26  # 256 MiB of int32 overwritten before a timed call


def modeled_ms(workload, directive, hw):
    return workload.analytic_cost(directive, hw) * 1e3


def kernel_module(wname):
    """The kernel wrapper a workload's PALLAS_RDMA / HYBRID build launches."""
    from repro_torch.kernels import (gemm_allgather, kv_shuttle,
                                     moe_dispatch, ring_attention)
    return {"moe_dispatch": moe_dispatch, "kv_transfer": kv_shuttle,
            "gemm_allgather": gemm_allgather,
            "ring_attention": ring_attention}[wname]


def small_kw(wname, kw):
    """``kw`` with :data:`CUT`'s dimensions of ``wname`` over
    :data:`SMALL_DIV` (at least :data:`SMALL_MIN`), and the text listing
    the cut."""
    out = dict(kw)
    cut = []
    for k in CUT[wname]:
        if k in kw:
            out[k] = max(SMALL_MIN, kw[k] // SMALL_DIV)
            cut.append(f"{k} {kw[k]}->{out[k]}")
    return out, ", ".join(cut)


def inputs(w, device, seed):
    """Inputs of ``w`` at its own shape (not the verification size of
    ``example_inputs``) from a seeded ``torch.Generator``, f32: moe x
    (n, T, d), w1, w2 over sqrt of their depth; kv x (2, T, d) with the
    prefill rank's rows in row 0, wk and wv over sqrt(d); gemm_allgather
    a (n, M_l, K), b over sqrt(K); the ring q, k, v (n, BH, seq / n, hd)."""
    mesh = VirtualMesh(w.n_dev, device=device)
    if w.name == "moe_dispatch":
        return w.example_inputs(seed, mesh, T=w.T)
    if w.name == "ring_attention":
        return w.example_inputs(seed, mesh, sl=w.sl)
    g = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(generator=g, device=device, dtype=torch.float32)
    if w.name == "kv_transfer":
        x = torch.zeros((2, w.T, w.d), device=device)
        x[0] = torch.randn((w.T, w.d), **kw)
        return (x, torch.randn((w.d, w.dk), **kw) / w.d ** 0.5,
                torch.randn((w.d, w.dk), **kw) / w.d ** 0.5)
    return (torch.randn((w.n_dev, w.M // w.n_dev, w.K), **kw),
            torch.randn((w.K, w.N), **kw) / w.K ** 0.5)


def oracle(w, ins):
    """``w.reference(*ins)``; the ring's in slices of heads, each head's
    attention being its own, so that no score block passes
    :data:`SCORE_BYTES`."""
    if w.name != "ring_attention":
        return w.reference(*ins)
    q = ins[0]
    S = q.shape[0] * q.shape[2]
    step = max(1, SCORE_BYTES // (4 * S * S))
    return torch.cat([w.reference(*(t[:, h:h + step] for t in ins))
                      for h in range(0, q.shape[1], step)], dim=1)


def point_us(fn, ins, iters, flush=None):
    """(median, least, most) us of ``iters`` calls of ``fn(*ins)`` after
    one warm-up call. On CUDA ``flush`` is overwritten (the L2 with it)
    and the device synchronized before each call, which CUDA events
    bracket: a call's time is its device work and the host's enqueueing
    of it. On the CPU (``flush`` None) the host clock times each call."""
    fn(*ins)
    times = []
    for _ in range(iters):
        if flush is None:
            t0 = time.perf_counter()
            fn(*ins)
            times.append((time.perf_counter() - t0) * 1e6)
            continue
        flush.zero_()
        torch.cuda.synchronize(flush.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*ins)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3)
    return statistics.median(times), min(times), max(times)


def _measure(w, name, d, ins, want, *, device, iters, flush):
    """(median, least, most us, max abs err) of one point: its first call
    held to ``want``, then :func:`point_us`. A kernel point on CUDA must
    launch its kernel; either failure raises ``SuiteFailure``."""
    fn = w.build(d, VirtualMesh(w.n_dev, device=device))
    kernel = d.backend in KERNEL_BACKENDS and device.type == "cuda"
    kern = kernel_module(w.name) if kernel else None
    before = kern.launches() if kernel else 0
    tol = I8_TOL if d.tunable("wire_i8", 0) else RTOL
    with torch.no_grad(), _full_f32(device):
        got = fn(*ins)
        require(not kernel or kern.launches() > before,
                lambda: f"{name}: {d.backend} point launched no "
                        f"{kern.__name__.rsplit('.', 1)[1]} kernel")
        err = allclose(name, got, want, tol)
        del got
        us = point_us(fn, ins, iters, flush)
    return (*us, err)


def measured_rows(wname, kw, points, hw, *, device, small=False, iters=5,
                  seed=0, h100_us=None):
    """The ``_card`` rows of one shape of a figure: ``{row name: (us,
    derived)}``.

    ``points`` is ``[(row name, directive)]``, the first the point every
    speedup is measured over. ``hw`` is the context the modeled rows are
    priced on; ``derived`` holds the same point's H100-model us (its l3
    cost on the ``H100`` model of that context, or ``h100_us[name]`` for a
    figure whose modeled row is a formula of its own), the measured
    speedup over the first point (of medians), the least and the most of
    the timed calls (``range=``), the largest error against
    ``reference()``, the card's label and, with ``small``, what was cut. A
    point that ``check`` rejects is printed with the reason and gets no
    row."""
    device = torch.device(device)
    full = get_workload(wname, **kw)
    h100 = dataclasses.replace(hw, chip=H100)
    mkw, cut = small_kw(wname, kw) if small else (kw, "")
    w = get_workload(wname, **mkw)
    ins = inputs(w, device, seed)
    with torch.no_grad(), _full_f32(device):
        want = oracle(w, ins)
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=device) \
        if device.type == "cuda" else None
    label = card_label(device)
    out, base = {}, None
    for name, d in points:
        reason = full.check(d, hw)
        if reason:
            print(f"{name}: not measured: {'; '.join(reason)}",
                  file=sys.stderr)
            continue
        us, lo, hi, err = _measure(w, name, d, ins, want, device=device,
                                   iters=iters, flush=flush)
        base = us if base is None else base
        model = (h100_us or {}).get(name)
        model = modeled_ms(full, d, h100) * 1e3 if model is None else model
        out[name] = (us, f"h100_model={model:.3f}us "
                         f"speedup={base / us:.3f}x "
                         f"range={lo:.3f}-{hi:.3f}us max_abs_err={err:.3e} "
                         f"card={label}" + (f" small: {cut}" if cut else ""))
    del ins, want, flush
    return out


def interleave(rows, card):
    """``rows`` with each measured row after its modeled one."""
    out = []
    for row in rows:
        out.append(row)
        if row[0] in card:
            out.append((row[0] + "_card", *card[row[0]]))
    return out


RANGE = re.compile(r"range=([0-9.]+)-([0-9.]+)us")


def orderings(rows, points):
    """Per group of a figure's points (the rows' names less a point of
    ``points``): the points in the order of the modeled rows' times and in
    the order of the measured rows' medians, over the points measured, and
    the verdict: ``matches`` where the two orders agree; ``differs`` where
    the card puts a point ahead of one the model puts ahead of it, and the
    slowest call of the one is faster than the fastest of the other;
    ``unresolved`` where every such swap lies inside the calls' ranges.
    Returns ``[(group, modeled order, measured order, verdict)]``."""
    model = {n: us for n, us, _ in rows if not n.endswith("_card")}
    groups = {}
    for n, us, derived in rows:
        if not n.endswith("_card"):
            continue
        base = n[:-len("_card")]
        p = max((p for p in points if base.endswith("_" + p)
                 or base.endswith("/" + p)), key=len)
        lo, hi = map(float, RANGE.search(derived).groups())
        groups.setdefault(base[:-len(p) - 1], []).append(
            (p, model[base], us, lo, hi))
    out = []
    for g, pts in groups.items():
        swapped = [(a, b) for a in pts for b in pts
                   if a[1] < b[1] and b[2] < a[2]]
        verdict = ("matches" if not swapped else
                   "differs" if any(b[4] < a[3] for a, b in swapped)
                   else "unresolved")
        out.append((g, [p[0] for p in sorted(pts, key=lambda t: t[1])],
                    [p[0] for p in sorted(pts, key=lambda t: t[2])],
                    verdict))
    return out


def parser(doc, out_help, n_dev=None):
    """The flags of every figure command line: the reference's ``--out``
    and, with ``n_dev``, fig4's ``--n-dev``; plus ``--device`` (cuda
    unless cpu) and ``--chip``, the context the modeled rows are priced
    on."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    if n_dev is not None:
        ap.add_argument("--n-dev", type=int, default=n_dev,
                        help="expert/rank count for the sweep")
    ap.add_argument("--out", default=None, help=out_help)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chip", default="h100", choices=sorted(CHIPS))
    return ap


def main(run, doc, n_dev=None, argv=None):
    """The command line of a figure module (:func:`parser`; ``--out``
    defaults to ``build/figures/<module>.json``). Prints
    ``name,us_per_call,derived`` CSV."""
    args = parser(doc, "the table as bench-rows/v1 JSON (default "
                       "build/figures/<module>.json)", n_dev).parse_args(argv)
    kw = {"n_dev": args.n_dev} if n_dev is not None else {}
    out = args.out or FIGURES_DIR / (run.__module__.rsplit(".", 1)[1]
                                     + ".json")
    print_rows(run(args.device, chip=CHIPS[args.chip], out=out, **kw))
    return 0


def print_rows(rows):
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")


def finish(rows, out):
    """Write ``rows`` to ``out`` (its directory made) when given; return
    them."""
    if out is not None:
        from pathlib import Path
        path = Path(out)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_rows(path, rows)
    return rows
