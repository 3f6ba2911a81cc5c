"""Batched serving engine: prefill -> KV cache -> greedy/sampled decode
(port of ``repro/serve/engine.py``).

Also implements **disaggregated prefill/decode** (the paper's KV-transfer
workload at system level): ``prefill_remote(batch, shuttle_mesh=...)`` runs
prefill as the prefill tier and ships every attention cache block to the
decode tier through the hand-written Hopper ``kv_cache_shuttle`` kernel
(``repro_torch.kernels.kv_shuttle``); without a mesh the engine hands the
cache over as it is.

Sampling draws from ONE key stream: the engine seeds a ``torch.Generator``
once and every sample advances it, through prefill / generate /
decode_from_handoff, so two temperature>0 batches never sample alike,
while a new engine with the same seed replays the stream. ``serve`` draws
from one generator per request, seeded from ``(seed, rid)``, so a
request's samples do not depend on which requests share its batch.

Every model kind the reference serves is served here: attention (dense
and MoE), the recurrent kinds and the encoder-decoder, whose batch carries
``frames`` through ``prefill``, ``generate`` and ``prefill_remote``.
``serve`` batches attention caches only: a decode group of two or more
requests with recurrent state raises, as the reference's does.

Expert parallelism: with ``rules`` (a ``dist.sharding.Rules`` over a
``VirtualMesh`` of data and, or, model axes, such as
``launch.mesh.make_mesh((1, 4), ("data", "model"))``) every step passes
them to the model, whose MoE layers shard the batch and the experts over
the ranks (``models/moe.py``): over the data axis, or, for a replicated
``ep_mode``, over the model axis.
Under ``StepOptions(moe_backend="pallas")`` the engine builds the
kernel's f32 expert operands once (``models.model.with_kernel_weights``),
and every group ``serve`` steps goes through the kernel: a batch that
shards over the data ranks through ``_pallas_body``, any other (requests
admitted on other steps, with other prompt lengths or another
``max_new_tokens``) through its padded layout (``_padded_body``), which
computes what the reference's gathered body computes for that batch.

Elastic serving, the serving side of the fault loop: an optional
:class:`repro_torch.train.fault_tolerance.StragglerWatchdog` (``watchdog=``)
receives every decode step's wall time (after a synchronize on a card),
and :meth:`Engine.degrade` shrinks the engine onto the surviving ranks
(``should_replace`` -> drop the rank, degrade, keep serving), also from
``serve``'s ``on_step`` hook in the middle of a run. Under
``moe_backend="pallas"`` a degrade onto a width the kernel cannot take
raises, as ``models/moe.py`` does for such a shape; a caller that wants to
keep serving switches ``scfg.opts`` to ``moe_backend="xla"`` first.

Serving metrics ride a :class:`repro_torch.core.telemetry.MetricsRegistry`
(``metrics=``, one per engine otherwise): decode step-latency and prefill
latency histograms, tokens generated, decode steps, prefills, handoffs,
watchdog incidents and degrades.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.core.telemetry import MetricsRegistry
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.dist.sharding import Rules
from repro_torch.models import StepOptions, decode_step, prefill_step
from repro_torch.models.model import with_kernel_weights

_KV_LEAVES = ("k", "v", "ck", "cv")


def _stack_caches(caches):
    """Batch per-request (B=1) decode caches into one engine cache.

    Attention leaves (k/v/ck/cv) carry batch on axis 1; kpos is shared
    across the batch (all grouped requests sit at the same position), so
    any one copy is the group's."""
    if len(caches) == 1:
        return caches[0]
    out = {}
    for name, block in caches[0].items():
        nb = {}
        for leaf in block:
            if leaf in _KV_LEAVES:
                nb[leaf] = torch.cat([c[name][leaf] for c in caches], dim=1)
            elif leaf == "kpos":
                nb[leaf] = block[leaf]
            else:
                raise NotImplementedError(
                    f"serve: cannot batch cache leaf {leaf!r} "
                    "(recurrent state?)")
        out[name] = nb
    return out


def _split_cache(cache, n):
    """Inverse of :func:`_stack_caches`: n per-request (B=1) caches."""
    if n == 1:
        return [cache]
    for block in cache.values():
        for leaf in block:
            if leaf not in _KV_LEAVES and leaf != "kpos":
                raise NotImplementedError(
                    f"serve: cannot split cache leaf {leaf!r}")
    return [{name: {leaf: (x[:, i:i + 1] if leaf in _KV_LEAVES else x)
                    for leaf, x in block.items()}
             for name, block in cache.items()}
            for i in range(n)]


@dataclass
class ServeConfig:
    max_seq: int = 512
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0
    opts: StepOptions = None

    def __post_init__(self):
        if self.opts is None:
            self.opts = StepOptions()


class Engine:
    """Serves ``cfg`` with ``params`` (the port's params, on the device the
    engine runs on: that of ``params["embed"]``), its MoE layers sharded by
    ``rules`` (None: one device)."""

    def __init__(self, cfg, params, serve_cfg: ServeConfig, rules=None,
                 watchdog=None, metrics=None):
        self.cfg = cfg
        self.rules = rules
        if rules is not None and cfg.is_moe \
                and serve_cfg.opts.moe_backend == "pallas":
            params = with_kernel_weights(params, cfg)
        self.params = params
        self.scfg = serve_cfg
        self.device = params["embed"].device
        self.watchdog = watchdog          # optional StragglerWatchdog
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(serve_cfg.seed))
        self._gen = 0                     # bumped by degrade()

    def degrade(self, devices_or_n):
        """Elastic serving: shrink onto the survivors, given as their
        count or a sequence of them (devices or ranks).

        Rebuilds :class:`Rules` of the same kind over a one-axis
        ``VirtualMesh`` of the survivors' width on the engine's device,
        with the old mesh's axis (a mesh of several axes: ``"data"``, the
        reference's serving deployment shape); a single survivor drops the
        engine to the local (unsharded) path. Under ``moe_backend="pallas"`` with MoE layers, a width the
        kernel cannot take (it wants one expert per data rank,
        ``num_experts_padded == width``) raises ``ValueError`` here, before
        anything changes. Every rank of a ``VirtualMesh`` lives on the
        engine's device, so a running ``serve`` loop's request state
        (caches, last tokens, generators) stays valid as it is. Returns the
        new rules."""
        width = devices_or_n if isinstance(devices_or_n, int) \
            else len(list(devices_or_n))
        if width < 1:
            raise ValueError(f"degrade onto {width} survivors: serving "
                             "needs one at least")
        if (self.cfg.is_moe and self.scfg.opts.moe_backend == "pallas"
                and (width <= 1 or self.cfg.num_experts_padded != width)):
            raise ValueError(
                f"degrade under moe_backend='pallas': the kernel takes one "
                f"expert per data rank (num_experts_padded == width), and "
                f"this config has num_experts_padded="
                f"{self.cfg.num_experts_padded} for a new width of {width}"
                + (" (one survivor runs the local path, which has no "
                   "kernel)" if width <= 1 else "")
                + "; switch the engine's StepOptions to moe_backend='xla' "
                "to keep serving")
        if self.rules is None or width <= 1:
            self.rules = None
        else:
            mesh = VirtualMesh(width, device=self.device,
                               axis=self.rules.mesh.axis or "data")
            self.rules = Rules(mesh, self.rules.kind,
                               long_context=self.rules.long_context)
        self.metrics.counter("serve.degrades").inc()
        self._gen += 1
        return self.rules

    def _prefill(self, batch):
        with torch.no_grad():
            return prefill_step(self.params, batch, self.cfg, self.rules,
                                seq_len=self.scfg.max_seq, opts=self.scfg.opts)

    def _decode(self, cache, tok, pos):
        with torch.no_grad():
            return decode_step(self.params, cache, tok, pos, self.cfg,
                               self.rules, opts=self.scfg.opts)

    def _sample(self, logits, gen):
        if self.scfg.temperature <= 0:
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        probs = torch.softmax(logits[:, -1] / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _watch(self, step_s):
        """Feed one decode step's wall time to the watchdog, if any."""
        if self.watchdog is not None and self.watchdog.record(step_s):
            self.metrics.counter("serve.watchdog_incidents").inc()

    def _decode_one(self, cache, tok, pos):
        t0 = time.perf_counter()
        logits, cache = self._decode(cache, tok[:, None], pos)
        tok = self._sample(logits, self._rng)
        self._sync()
        step_s = time.perf_counter() - t0
        self._watch(step_s)
        self.metrics.histogram("serve.decode_step_ms").observe(step_s * 1e3)
        self.metrics.counter("serve.decode_steps").inc()
        self.metrics.counter("serve.tokens_generated").inc(int(tok.shape[0]))
        return tok, cache

    def prefill(self, batch):
        """batch: {"tokens": (B, S0), ...} -> (first_token, cache, pos)."""
        t0 = time.perf_counter()
        logits, cache = self._prefill(batch)
        tok = self._sample(logits, self._rng)
        self._sync()
        self.metrics.histogram("serve.prefill_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        self.metrics.counter("serve.prefills").inc()
        self.metrics.counter("serve.prefill_tokens").inc(
            int(batch["tokens"].shape[0] * batch["tokens"].shape[1]))
        return tok, cache, batch["tokens"].shape[1]

    def generate(self, batch, max_new_tokens):
        """Batched greedy/sampled generation. Returns (B, new) tokens."""
        tok, cache, pos = self.prefill(batch)
        return self._decode_loop(tok, cache, pos, max_new_tokens)

    def _decode_loop(self, tok, cache, pos, max_new_tokens):
        out = [tok]
        for i in range(max_new_tokens - 1):
            tok, cache = self._decode_one(cache, tok, pos + i)
            out.append(tok)
        return torch.stack(out, dim=1)

    # ---- continuous batching --------------------------------------------
    def _req_gen(self, rid):
        # per-request stream: independent of batch composition and of the
        # engine-level stream used by generate()
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self.scfg.seed) * 1_000_003 + int(rid))
        return g

    def serve(self, scheduler, on_step=None, max_steps=10_000):
        """Continuous-batching loop over a :class:`repro_torch.serve.
        scheduler.Scheduler`: each step decodes the scheduler's claims
        (grouped by position so one ``decode_step`` serves each group) and
        prefills its admissions. ``on_step(step_no, engine)`` runs after
        every step — the fault-injection hook for elastic serving: it may
        :meth:`degrade` the engine, and the requests go on from their
        state. Returns ``{rid: (tokens,) int32}``."""
        states, done = {}, {}
        step_no = 0
        while scheduler.pending:
            if step_no >= max_steps:
                raise RuntimeError(
                    f"serve: {max_steps} steps with requests still pending")
            decode_rids, admits = scheduler.plan_step()

            groups = {}
            for rid in decode_rids:
                groups.setdefault(states[rid]["pos"], []).append(rid)
            for pos, rids in sorted(groups.items()):
                toks = torch.cat([states[r]["tok"] for r in rids])
                cache = _stack_caches([states[r]["cache"] for r in rids])
                t0 = time.perf_counter()
                logits, cache = self._decode(cache, toks[:, None], pos)
                self._sync()
                step_s = time.perf_counter() - t0
                self._watch(step_s)
                self.metrics.histogram("serve.decode_step_ms").observe(
                    step_s * 1e3)
                self.metrics.counter("serve.decode_steps").inc()
                self.metrics.counter("serve.tokens_generated").inc(len(rids))
                parts = _split_cache(cache, len(rids))
                for i, rid in enumerate(rids):
                    st = states[rid]
                    tok = self._sample(logits[i:i + 1], st["gen"])
                    st.update(tok=tok, cache=parts[i], pos=pos + 1)
                    st["out"].append(int(tok[0]))

            for group in self._prefill_groups(admits):
                batch = {"tokens": torch.tensor([r.prompt for r in group],
                                                dtype=torch.long,
                                                device=self.device)}
                logits, cache = self._prefill(batch)
                parts = _split_cache(cache, len(group))
                for i, req in enumerate(group):
                    gen = self._req_gen(req.rid)
                    tok = self._sample(logits[i:i + 1], gen)
                    states[req.rid] = {"cache": parts[i],
                                       "pos": req.prompt_len, "tok": tok,
                                       "gen": gen, "out": [int(tok[0])]}
                    self.metrics.counter("serve.prefills").inc()
                    self.metrics.counter("serve.prefill_tokens").inc(
                        req.prompt_len)

            for rid in list(states):
                if len(states[rid]["out"]) >= \
                        scheduler.active[rid].max_new_tokens:
                    done[rid] = torch.tensor(states.pop(rid)["out"],
                                             dtype=torch.int32)
                    scheduler.finish(rid)

            self.metrics.counter("serve.steps").inc()
            if on_step is not None:
                on_step(step_no, self)
            step_no += 1
        return done

    def _prefill_groups(self, admits):
        """A step's admissions as prefill batches: one request each, as in
        the reference, except under ``rules`` over dp > 1 data ranks, where
        requests of one prompt length go dp at a time, one request a rank,
        so the batch shards over the data axis. Each rank's MoE capacity
        is then its request's own, as in a prefill of that request alone,
        so the tokens are the same. The requests left over go one at a
        time, as in the reference (under ``moe_backend="pallas"``: through
        the kernel's padded layout)."""
        dp = self.rules.dp_size() if self.rules is not None else 1
        if dp <= 1:
            return [[r] for r in admits]
        by_len = {}
        for r in admits:
            by_len.setdefault(r.prompt_len, []).append(r)
        groups = []
        for reqs in by_len.values():
            full = len(reqs) - len(reqs) % dp
            groups += [reqs[i:i + dp] for i in range(0, full, dp)]
            groups += [[r] for r in reqs[full:]]
        return groups

    # ---- disaggregated prefill/decode tiers ------------------------------
    def _check_shuttle_mesh(self, mesh):
        if mesh.n != 2:
            raise ValueError(f"the shuttle runs on a 2-rank mesh, got {mesh}")
        dev = self.device
        if mesh.device.type != dev.type or mesh.device.index not in (
                None, dev.index if dev.index is not None else 0):
            raise ValueError(f"{mesh} is not on the cache's device {dev}")

    def _shuttle_cache(self, cache, mesh, **kw):
        """Push every attention KV block through the ``kv_cache_shuttle``
        kernel (prefill rank 0 -> decode rank 1 of ``mesh``) and return the
        cache rebuilt from what landed on the decode rank. Paired leaves
        ([k, v] and [ck, cv]) ride one shuttle each as stacked ``[K; V]``
        row blocks."""
        from repro_torch.kernels.kv_shuttle import kv_cache_shuttle
        out = {}
        for name, block in cache.items():
            if not (isinstance(block, dict) and "k" in block):
                raise NotImplementedError(
                    f"serve: cannot shuttle cache block {name!r}")
            nb = dict(block)
            for a, b in (("k", "v"), ("ck", "cv")):
                if a not in block:
                    continue
                ka, vb = block[a], block[b]
                stacked = torch.cat([ka.reshape(-1, ka.shape[-1]),
                                     vb.reshape(-1, vb.shape[-1])])
                kv = torch.stack([stacked, torch.zeros_like(stacked)])
                ko, vo = kv_cache_shuttle(kv, **kw)
                nb[a] = ko[1].reshape(ka.shape)
                nb[b] = vo[1].reshape(vb.shape)
            out[name] = nb
        return out

    def prefill_remote(self, batch, shuttle_mesh=None, **shuttle_kw):
        """Prefill-tier step: returns the handoff to ship to decode. With
        ``shuttle_mesh`` (a 2-rank ``VirtualMesh``) the KV blocks ride the
        ``kv_cache_shuttle`` kernel and the handoff cache is what landed on
        the decode rank; without it the engine hands the cache over. The
        mesh must sit on the engine's device: the cache is never moved."""
        if shuttle_mesh is not None:
            self._check_shuttle_mesh(shuttle_mesh)
        tok, cache, pos = self.prefill(batch)
        if shuttle_mesh is not None:
            cache = self._shuttle_cache(cache, shuttle_mesh, **shuttle_kw)
        self.metrics.counter("serve.kv_handoffs").inc()
        return {"first_token": tok, "cache": cache, "pos": pos}

    def decode_from_handoff(self, handoff, max_new_tokens):
        return self._decode_loop(handoff["first_token"], handoff["cache"],
                                 handoff["pos"], max_new_tokens)
