"""Cascade evaluation (paper §3.3): every offspring passes a fast-fail
cascade — l0 static schedule verification (``core/verify.py``), l1 build
plus the kernel build/load, l2 numerical verification against the workload
oracle, l3 benchmark. Score = 10000 / (1 + t_ms); candidates failing
l0/l1/l2 score 0 and carry a diagnostic plus a deterministic
``rejection`` class ("l0:<checker code>", "l1:build", "l2:mismatch", ...).

Port of ``repro/core/cascade.py``. l3 is the workload's analytic cost on
the context's chip (``core/hardware.py``: ``H100`` for the card) and, with
``wallclock=True``, the CUDA-event time of the built program on the
verification inputs (host clock on the CPU; the record names the device).

Hardened for unattended search as the reference is: ``timeout_s`` abandons
a wedged candidate into ``quarantine``; one retry with backoff for flaky
l2 executions; ``fault_plans`` (``core/faults.py``) priced at l3 into
``EvalResult.fault_report``, with ``fault_weight`` folding the mean
degraded-ms penalty into the score, so the search optimizes a
(throughput, fault-survival) trade-off.
:meth:`CascadeEvaluator.evaluate_batch` keeps the
reference's parity contract (results, records and quarantine entries equal
to per-candidate :meth:`evaluate` in order). On a CUDA device the batch's
l2 runs are serialized onto one stream: two persistent spin-waiting
kernels on two streams could starve each other of multiprocessors.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch

from repro_torch.core.design_space import Directive


def _device_name(device):
    """``cpu``, or ``cuda:0 (NVIDIA H100 80GB HBM3)`` — what every record
    says it ran on."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


@contextlib.contextmanager
def _full_f32(device):
    """Matmuls in full f32 on a card (TF32 would eat most of the l2
    tolerance), restoring the caller's setting after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _leaves(out):
    """The tensors of a build's output (a tensor or a tuple of them)."""
    return list(out) if isinstance(out, (tuple, list)) else [out]


@dataclass
class EvalResult:
    level: int                    # highest level passed (0..3)
    score: float
    t_model_ms: float = float("inf")
    t_wall_ms: float = float("inf")
    diagnostic: str = ""
    fault_report: dict = field(default_factory=dict)  # plan -> healthy/degraded ms
    quarantined: bool = False     # abandoned at the wall-clock deadline
    retries: int = 0              # flaky-l2 re-executions that were needed
    rejection: str = ""           # deterministic rejection class ("" = passed)
    record: object = None         # telemetry.EvalRecord (every path sets one)

    @property
    def ok(self):
        return self.level >= 3


@dataclass
class Candidate:
    directive: Directive
    gen: int = 0
    island: int = 0
    parent_id: int = -1
    mutation: str = "seed"
    cid: int = -1
    result: EvalResult | None = None
    code_text: str = ""           # what l1 built and loaded
    cached: bool = False          # result reused from a warm-start store

    @property
    def score(self):
        return self.result.score if self.result else 0.0


class CascadeEvaluator:
    def __init__(self, workload, mesh, hw, *, rtol=2e-3, wallclock=False,
                 verify_inputs=None, timeout_s=None, l2_retries=1,
                 backoff_s=0.05, fault_plans=(), fault_weight=0.0,
                 batch_workers=None):
        self.workload = workload
        self.mesh = mesh
        self.hw = hw
        self.rtol = rtol
        self.wallclock = wallclock
        self.timeout_s = timeout_s
        self.l2_retries = max(0, int(l2_retries))
        self.backoff_s = backoff_s
        self.fault_plans = tuple(fault_plans)
        self.fault_weight = fault_weight
        self.batch_workers = max(1, int(
            batch_workers or min(4, os.cpu_count() or 1)))
        self.quarantine = []          # wedged-candidate diagnostics
        self.records = []             # telemetry.EvalRecord per evaluation
        self.device = _device_name(mesh.device)
        self.inputs = verify_inputs or workload.example_inputs(1234, mesh)
        with torch.no_grad(), _full_f32(mesh.device):
            self.expected = workload.reference(*self.inputs)

    def evaluate(self, cand: Candidate) -> EvalResult:
        """Evaluate one candidate under the wall-clock budget, publishing
        its record (and quarantine entry, if any) immediately."""
        res, _ = self._guarded(cand, publish=True)
        return res

    def evaluate_batch(self, cands, *, max_workers=None) -> list:
        """Evaluate a whole generation at once — the parity contract
        (docs/search.md): the returned ``EvalResult``s, the appended
        ``records`` and the ``quarantine`` entries are identical to calling
        :meth:`evaluate` per candidate in order (wall timings aside).

        The l2 executions fan out across a bounded worker pool of
        at most ``max_workers`` (default ``batch_workers``) threads; l1
        build/lower and l3 analytic costing ride the same per-candidate
        pass (pure trace-time math — cheap and thread-safe). Each pool task
        keeps the sequential path's per-candidate ``timeout_s`` discipline:
        the abandonable deadline thread is spawned inside the pool task, so
        a wedged candidate frees its pool slot at the deadline instead of
        starving the batch. Publication of records and quarantine entries
        is deferred and replayed in input order after the pool drains."""
        cands = list(cands)
        if not cands:
            return []
        workers = max(1, min(int(max_workers or self.batch_workers),
                             len(cands)))
        if self.mesh.device.type == "cuda":
            workers = 1                   # one stream for the kernels
        outs = [None] * len(cands)

        def one(i):
            outs[i] = self._guarded(cands[i], publish=False)

        if workers == 1:
            for i in range(len(cands)):
                one(i)
        else:
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="cascade-batch") as px:
                list(px.map(one, range(len(cands))))
        results = []
        for res, qentry in outs:
            if res.record is not None:
                self.records.append(res.record)
            if qentry is not None:
                self.quarantine.append(qentry)
            results.append(res)
        return results

    def _guarded(self, cand: Candidate, publish=True):
        """The full timeout-guarded cascade for one candidate: the body
        runs on a daemon thread; past ``timeout_s`` the candidate is
        quarantined (the wedged thread is abandoned — it holds no locks
        the search needs) and the caller moves on. Returns ``(result,
        quarantine_entry_or_None)``; with ``publish=False`` nothing is
        appended to ``records``/``quarantine`` — the batch path replays
        publication in input order."""
        if not self.timeout_s:
            return self._evaluate(cand, publish=publish), None
        box = {}

        def run():
            try:
                box["res"] = self._evaluate(cand, publish=publish)
            except BaseException as e:        # surfaced below, never lost
                box["err"] = e

        th = threading.Thread(target=run, daemon=True,
                              name=f"cascade-eval-{cand.cid}")
        t0 = time.perf_counter()
        th.start()
        th.join(self.timeout_s)
        if th.is_alive():
            elapsed = time.perf_counter() - t0
            stage = getattr(cand, "_stage", "")
            diag = (f"quarantined: evaluation exceeded {self.timeout_s:.2f}s "
                    "wall-clock (wedged build/execute abandoned"
                    + (f" at {stage}" if stage else "") + ")")
            # flag first: the abandoned thread must not append a late
            # duplicate record if it ever comes back from the wedge
            cand._quarantined = True
            res = EvalResult(0, 0.0, diagnostic=diag, quarantined=True,
                             rejection="quarantine")
            res = self._record(cand, res, {"quarantine": elapsed},
                               force=True, publish=publish)
            entry = {
                "cid": cand.cid, "directive": repr(cand.directive),
                "elapsed_s": elapsed, "diagnostic": diag, "stage": stage,
                "record": res.record.to_dict()}
            if publish:
                self.quarantine.append(entry)
            return res, entry
        if "err" in box:
            elapsed = time.perf_counter() - t0
            e = box["err"]
            res = EvalResult(0, 0.0, rejection="error",
                             diagnostic="evaluator error:\n" + "".join(
                traceback.format_exception(type(e), e, e.__traceback__))[-1500:])
            return self._record(cand, res, {"error": elapsed},
                                publish=publish), None
        return box["res"], None

    def quarantine_report(self):
        """Diagnostics of every candidate abandoned at the deadline."""
        return list(self.quarantine)

    def _run_l2(self, fn):
        """The l2 execution boundary — a deliberate seam: tests wrap it to
        inject flaky executions or wire faults."""
        with torch.no_grad():
            out = fn(*self.inputs)
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        return out

    def _verify_l0(self, d):
        """The l0 static-verification boundary — a seam like
        :meth:`_run_l2`: tests wrap it to inject mutated programs.
        Returns a ``verify.VerifyReport`` or ``None`` when the directive
        realizes no collective schedule (XLA backends, solo tiers) — a
        vacuous pass."""
        from repro_torch.core.verify import verify_directive
        return verify_directive(self.workload, d)

    def _record(self, cand, res: EvalResult, levels, *, fault_penalty_ms=0.0,
                force=False, publish=True) -> EvalResult:
        """Attach the structured telemetry row for one evaluation; every
        evaluate path (success, l1/l2 fail, error, quarantine) routes
        through here. A candidate already quarantined by the deadline
        watcher is skipped unless ``force``d — the abandoned worker thread
        must not append a late duplicate. ``publish=False`` attaches the
        record to the result only; the batch path appends it to
        ``records`` later, in input order."""
        if getattr(cand, "_quarantined", False) and not force:
            return res
        from repro_torch.core.telemetry import EvalRecord
        try:
            knobs = dict(self.workload.kernel_knobs(cand.directive))
        except Exception:
            knobs = {}
        rec = EvalRecord(
            cid=cand.cid, gen=cand.gen, island=cand.island,
            mutation=cand.mutation, directive=repr(cand.directive),
            level=res.level, score=res.score,
            t_model_ms=res.t_model_ms
            if math.isfinite(res.t_model_ms) else None,
            t_wall_ms=res.t_wall_ms if math.isfinite(res.t_wall_ms) else None,
            levels_s={k: float(v) for k, v in levels.items()},
            retries=res.retries, quarantined=res.quarantined,
            fault_penalty_ms=float(fault_penalty_ms), knobs=knobs,
            diagnostic=res.diagnostic,
            elapsed_s=float(sum(levels.values())),
            rejection=res.rejection,
            stage=getattr(cand, "_stage", ""), device=self.device)
        res.record = rec
        if publish:
            self.records.append(rec)
        return res

    def _evaluate(self, cand: Candidate, publish=True) -> EvalResult:
        d = cand.directive
        levels = {}
        # ---- l0: directive validity + static schedule verification ------
        cand._stage = "l0"
        viol = self.workload.check(d, self.hw)
        if viol:
            return self._record(
                cand, EvalResult(0, 0.0, rejection="invalid",
                                 diagnostic="invalid directive: "
                                 + "; ".join(viol)), levels, publish=publish)
        t0 = time.perf_counter()
        vrep = self._verify_l0(d)
        levels["l0"] = time.perf_counter() - t0
        if vrep is not None and not vrep.ok:
            # a structured VerifyError diagnostic: the mutation feedback
            # loop reads the class prefix, telemetry keys on `rejection`
            return self._record(
                cand, EvalResult(0, 0.0,
                                 rejection="l0:" + vrep.errors[0].code,
                                 diagnostic="l0 schedule verify failed: "
                                 + vrep.summary()), levels, publish=publish)
        # ---- l1: build + kernel build/load ------------------------------
        cand._stage = "l1"
        t1 = time.perf_counter()
        try:
            fn = self.workload.build(d, self.mesh)
            cand.code_text = self.workload.load_kernels(d, self.mesh)
        except Exception:
            levels["l1"] = time.perf_counter() - t1
            return self._record(
                cand, EvalResult(0, 0.0, rejection="l1:build",
                                 diagnostic="l1 build/lower failed:\n"
                                 + traceback.format_exc()[-1500:]), levels,
                publish=publish)
        levels["l1"] = time.perf_counter() - t1
        # ---- l2: numerical verification ---------------------------------
        # transient execution errors retry with backoff; a deterministic
        # verify mismatch below never does
        cand._stage = "l2"
        t2 = time.perf_counter()
        retries = 0
        while True:
            try:
                with _full_f32(self.mesh.device):
                    out = self._run_l2(fn)
                break
            except Exception:
                if retries >= self.l2_retries:
                    levels["l2"] = time.perf_counter() - t2
                    return self._record(
                        cand, EvalResult(1, 0.0, retries=retries,
                                         rejection="l2:execute",
                                         diagnostic="l2 execution failed:\n"
                                         + traceback.format_exc()[-1500:]),
                        levels, publish=publish)
                retries += 1
                time.sleep(self.backoff_s * retries)
        tol = self.rtol
        if d.tunable("wire_i8", 0):
            tol = max(tol, 8e-2)          # quantized wire is lossy by design
        for got, exp in zip(_leaves(out), _leaves(self.expected)):
            got = got.to(torch.float32)
            exp = exp.to(torch.float32)
            if not bool(torch.isfinite(got).all()):
                levels["l2"] = time.perf_counter() - t2
                return self._record(
                    cand, EvalResult(1, 0.0, retries=retries,
                                     rejection="l2:nonfinite", diagnostic=(
                        "l2 verify failed: non-finite values (deadlock-free "
                        "but corrupt transfer — check completion/ordering)")),
                    levels, publish=publish)
            err = float((got - exp).abs().max()
                        / (exp.abs().max() + 1e-9))
            if err > tol:
                levels["l2"] = time.perf_counter() - t2
                return self._record(
                    cand, EvalResult(1, 0.0, retries=retries,
                                     rejection="l2:mismatch", diagnostic=(
                        f"l2 verify failed: rel err {err:.3e} > {tol:.0e} "
                        f"(placement={d.placement}, "
                        f"completion={d.completion})")), levels,
                    publish=publish)
        levels["l2"] = time.perf_counter() - t2
        # ---- l3: benchmark ----------------------------------------------
        cand._stage = "l3"
        t3 = time.perf_counter()
        t_model = self.workload.analytic_cost(d, self.hw)
        t_ms = t_model * 1e3
        fault_report = {}
        if self.fault_plans:
            from repro_torch.core.faults import survival_report
            fault_report = survival_report(self.workload, d, self.hw,
                                           self.fault_plans)
        # fault-survival trade-off: the score price of a plan is its mean
        # degraded-over-healthy penalty; a plan the candidate cannot
        # survive prices as +inf and zeroes the score (level stays 3 — the
        # candidate is correct, just fragile)
        t_eff = t_ms
        if fault_report and self.fault_weight:
            pens = [max(0.0, e["degraded_ms"] - e["healthy_ms"])
                    for e in fault_report.values()]
            t_eff = t_ms + self.fault_weight * sum(pens) / len(pens)
        levels["l3"] = time.perf_counter() - t3
        t_wall = float("inf")
        if self.wallclock:
            from repro_torch.core.telemetry import wallclock_us
            tw = time.perf_counter()
            with torch.no_grad(), _full_f32(self.mesh.device):
                t_wall = wallclock_us(fn, self.inputs) / 1e3
            levels["wallclock"] = time.perf_counter() - tw
        return self._record(
            cand, EvalResult(3, 10000.0 / (1.0 + t_eff), t_model_ms=t_ms,
                             t_wall_ms=t_wall, fault_report=fault_report,
                             retries=retries,
                             diagnostic=f"ok: modeled {t_ms:.3f} ms"),
            levels, fault_penalty_ms=t_eff - t_ms, publish=publish)
