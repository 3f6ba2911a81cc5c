"""Request scheduler for continuous batching — the admission/assembly
policy in front of :class:`repro_torch.serve.engine.Engine`.

The serving loop is step-synchronous: each engine step spends a **token
budget** (decode slots cost 1 token, an admission costs the request's
whole prompt), and :meth:`Scheduler.plan_step` decides how to spend it:

* **decode claims** — active requests claim one decode token each, in
  admission order, rotated after every step so that when the budget (or
  ``max_batch``) is smaller than the active set, the unserved requests go
  first next step — no request starves.
* **admission** — strict head-of-line FIFO over the waiting queue: the
  oldest waiting request is admitted iff its full prompt still fits in
  the step's remaining budget and a batch slot is free. Younger requests
  never jump the queue (the no-starvation guarantee extends to waiting
  requests).

The scheduler owns policy only — queues, ordering, and the budget
invariant (per-step spent tokens ≤ ``token_budget``, checked in
tier-1 ``tests/test_serving.py``). The engine owns all model state
(caches, keys, sampled tokens) in its ``serve`` loop and reports
completions back via :meth:`finish`. Instrumented through
:class:`repro_torch.core.telemetry.MetricsRegistry` (``sched.*`` series).
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Request", "Scheduler"]


@dataclass
class Request:
    """One user request: a prompt (token ids) and a decode allowance."""
    rid: int
    prompt: tuple
    max_new_tokens: int = 8

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")

    @property
    def prompt_len(self):
        return len(self.prompt)


@dataclass
class Scheduler:
    token_budget: int = 32
    max_batch: int = 8
    metrics: object = None
    waiting: list = field(default_factory=list)    # FIFO of Request
    active: dict = field(default_factory=dict)     # rid -> Request
    _order: list = field(default_factory=list)     # admission order, rotated

    def __post_init__(self):
        if self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request):
        """Queue a request. A prompt longer than the whole budget could
        never be admitted — reject it at the door instead of starving the
        queue behind it."""
        if req.prompt_len > self.token_budget:
            raise ValueError(
                f"request {req.rid}: prompt_len {req.prompt_len} exceeds "
                f"token_budget {self.token_budget}")
        if req.rid in self.active or any(w.rid == req.rid
                                         for w in self.waiting):
            raise ValueError(f"duplicate rid {req.rid}")
        self.waiting.append(req)
        if self.metrics is not None:
            self.metrics.counter("sched.submitted").inc()

    def finish(self, rid):
        """Engine reports a request complete: free its batch slot."""
        self.active.pop(rid)
        self._order.remove(rid)
        if self.metrics is not None:
            self.metrics.counter("sched.finished").inc()

    @property
    def pending(self):
        return bool(self.waiting or self.active)

    # --------------------------------------------------------------- policy
    def plan_step(self):
        """Plan one engine step under the token budget.

        Returns ``(decode_rids, admits)``: active requests that decode one
        token this step (≤ ``max_batch``, ≤ budget), and newly admitted
        requests (FIFO, each costing its prompt length). Invariant:
        ``len(decode_rids) + sum(prompt_len)  <=  token_budget``.
        """
        used = 0
        decode = []
        for rid in self._order:
            if len(decode) >= self.max_batch or used >= self.token_budget:
                break
            decode.append(rid)
            used += 1
        # rotate the served prefix to the back: requests that missed this
        # step head the order next step (starvation-freedom under a budget
        # smaller than the active set)
        k = len(decode)
        if 0 < k < len(self._order):
            self._order = self._order[k:] + self._order[:k]

        admits = []
        while (self.waiting
               and len(self.active) + len(admits) < self.max_batch
               and used + self.waiting[0].prompt_len <= self.token_budget):
            req = self.waiting.pop(0)
            admits.append(req)
            used += req.prompt_len
        for req in admits:
            self.active[req.rid] = req
            self._order.append(req.rid)

        if self.metrics is not None:
            self.metrics.histogram("sched.step_tokens").observe(used)
            self.metrics.gauge("sched.active").set(len(self.active))
            self.metrics.gauge("sched.waiting").set(len(self.waiting))
            if admits:
                self.metrics.counter("sched.admitted").inc(len(admits))
        assert used <= self.token_budget, (used, self.token_budget)
        return decode, admits
