"""Phase-dependent variation operator — LLMMutate, Algorithm 2 (paper
Appendix I) — with the paper's three mutation forms:

  REWRITE   — large-step: resample several dimensions (architectural change)
  DIFF      — fine-grained: perturb one dimension or one numeric tunable
  CROSSOVER — synthesize from the parent + a MAP-Elites archive inspiration

The operator is *bounded*: it can only emit points of C that validate for
the workload's traits (the paper's "LLMs as bounded operators over
domain-defined search spaces"). Two implementations share the contract:

  * HeuristicMutator — deterministic, semantically informed (consumes the
    same MutationContext the paper feeds its LLM: parent + feedback, archive
    inspirations, meta-recommendations, hardware context) — used offline.
  * LLMMutator — assembles the paper's prompt (backend-conditioned API
    context, strategy knowledge, hardware context, directive syntax) and
    delegates to a user-supplied ``llm_fn``; for API-connected deployments.

Port copy of ``repro/core/mutation.py``: the heuristic operator is the
reference's line for line (the same directives for the same
``random.Random`` state); the prompt's API context describes the program
the card runs instead of the TPU's.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field

from repro_torch.core.design_space import (DIMENSIONS, Directive, is_valid,
                                     random_directive)


@dataclass
class MutationContext:
    parent: "Candidate"
    phase: str                       # "explore" | "exploit"
    archive_samples: list = field(default_factory=list)
    neighbors: list = field(default_factory=list)     # (sim, Candidate)
    recommendations: list = field(default_factory=list)
    hardware: object = None
    traits: dict = field(default_factory=dict)
    tunable_space: dict = field(default_factory=dict)  # name -> candidates


class MutationOperator:
    def propose(self, ctx: MutationContext, rng: random.Random) -> tuple:
        """Returns (directive, mutation_kind)."""
        raise NotImplementedError


# --------------------------------------------------------------- heuristic

# dimensions most likely to move the needle for a given bottleneck diagnosis
_BOTTLENECK_DIMS = {
    "collective": ("placement", "backend", "granularity", "contexts"),
    "compute": ("granularity", "issuer", "contexts"),
    "overhead": ("completion", "ordering", "scope"),
}


class HeuristicMutator(MutationOperator):
    """Semantically informed bounded operator. Explore = high-temperature
    rewrites/crossovers toward structurally different behaviors; exploit =
    low-temperature single-dimension diffs biased by feedback and
    meta-recommendations.

    ``bounded=False`` disables the design-space bounding (candidates are
    free combinations, possibly invalid) — the ablation analogue of the
    paper's "unconstrained code generation" baseline, where the cascade must
    reject broken candidates at l1.
    """

    def __init__(self, bounded: bool = True):
        self.bounded = bounded

    def propose(self, ctx, rng):
        parent = ctx.parent.directive
        traits = ctx.traits
        if ctx.phase == "explore":
            form = rng.choices(["rewrite", "crossover", "diff"],
                               weights=[0.6, 0.25, 0.15])[0]
        else:
            form = rng.choices(["diff", "crossover", "rewrite"],
                               weights=[0.7, 0.2, 0.1])[0]
        if form == "crossover" and not ctx.archive_samples:
            form = "rewrite" if ctx.phase == "explore" else "diff"

        if not self.bounded and form == "rewrite":
            d = Directive(**{k: rng.choice(v) for k, v in DIMENSIONS.items()})
            return self._retune(d, ctx, rng), "rewrite-unbounded"
        if form == "rewrite":
            d = self._rewrite(parent, ctx, rng)
        elif form == "crossover":
            d = self._crossover(parent, ctx.archive_samples, rng, traits)
        else:
            d = self._diff(parent, ctx, rng)
        if self.bounded and not is_valid(d, **traits):
            d = random_directive(rng, **traits)
        return d, form

    # explore: propose a structurally different strategy, honoring
    # meta-recommendations about untried high-value behaviors
    def _rewrite(self, parent, ctx, rng):
        for rec in ctx.recommendations:
            if rec.get("kind") == "try_behavior":
                cand = dataclasses.replace(
                    parent, backend=rec["backend"], placement=rec["placement"],
                    completion=rec["completion"])
                cand = self._retune(cand, ctx, rng)
                if is_valid(cand, **ctx.traits) and rng.random() < 0.7:
                    return cand
        d = random_directive(rng, **ctx.traits)
        # bias exploration toward overlap-capable placements — the hardware
        # context says communication sits on the critical path
        if rng.random() < 0.6 and d.placement == "DEFERRED":
            for p in ("TILE_PIPELINED", "STREAM_SPLIT", "TILE_FUSED"):
                cand = dataclasses.replace(d, placement=p, contexts=2)
                if is_valid(cand, **ctx.traits):
                    d = cand
                    break
        return self._retune(d, ctx, rng)

    def _crossover(self, parent, samples, rng, traits):
        other = rng.choice(samples).directive
        kw = {}
        for dim in DIMENSIONS:
            kw[dim] = getattr(other if rng.random() < 0.5 else parent, dim)
        merged = dict(parent.tunables)
        merged.update({k: v for k, v in other.tunables if rng.random() < 0.5})
        d = Directive(**kw, tunables=tuple(sorted(merged.items())))
        return d if is_valid(d, **traits) else parent

    # exploit: one semantically-targeted move
    def _diff(self, parent, ctx, rng):
        fb = (ctx.parent.result.diagnostic if ctx.parent.result else "") or ""
        # feedback routing: verification failures point at sync dims
        if "verify failed" in fb or "non-finite" in fb:
            dims = ("completion", "ordering", "contexts")
        elif "invalid directive" in fb or "build" in fb:
            dims = ("backend", "placement")
        else:
            # performance refinement: prefer tunables, then overlap dims
            if ctx.tunable_space and rng.random() < 0.5:
                name = rng.choice(sorted(ctx.tunable_space))
                cand = self._apply_tunable(parent, name, ctx, rng)
                if cand is not None:
                    return cand
            dims = _BOTTLENECK_DIMS.get(self._bottleneck(ctx),
                                        tuple(DIMENSIONS)[:6])
        dim = rng.choice(dims)
        options = [v for v in DIMENSIONS[dim] if v != getattr(parent, dim)]
        for v in rng.sample(options, len(options)):
            d = dataclasses.replace(parent, **{dim: v})
            if dim == "placement" and v in ("TILE_PIPELINED",) \
                    and d.contexts < 2:
                d = dataclasses.replace(d, contexts=2)
            if is_valid(d, **ctx.traits):
                return d
        return parent

    @staticmethod
    def _set_knob(d, name, value, ctx):
        """Set one knob. ``contexts`` lives on the directive itself (a
        dimension of C), every other knob in the tunables tuple; returns
        None when the move produces an invalid directive."""
        if name == "contexts":
            cand = dataclasses.replace(d, contexts=value)
            return cand if is_valid(cand, **ctx.traits) else None
        return d.with_tunable(name, value)

    def _apply_tunable(self, parent, name, ctx, rng):
        """One diff-patch knob move; returns None when no distinct valid
        value exists."""
        cur = parent.contexts if name == "contexts" else parent.tunable(name)
        vals = [v for v in ctx.tunable_space[name] if v != cur]
        for v in rng.sample(vals, len(vals)):
            cand = self._set_knob(parent, name, v, ctx)
            if cand is not None:
                return cand
        return None

    def _retune(self, d, ctx, rng):
        for name, vals in ctx.tunable_space.items():
            if rng.random() < 0.5:
                cand = self._set_knob(d, name, rng.choice(list(vals)), ctx)
                if cand is not None:
                    d = cand
        return d

    def _bottleneck(self, ctx):
        for rec in ctx.recommendations:
            if rec.get("kind") == "bottleneck":
                return rec["which"]
        return "collective"


# --------------------------------------------------------------------- LLM

PROMPT_TEMPLATE = """You are optimizing a compute-communication co-designed
GPU program. Emit an OPTIMIZATION DIRECTIVE selecting one value per dimension
— nothing else. Dimensions and allowed values:
{space}

Hardware context:
{hardware}

Backend-conditioned API context:
{api_context}

Strategy knowledge: kernel-level fusion suits iterative fine-grained
exchanges; stream-level overlap suits bulk transfers between large compute
phases; split put/wait suits pipelines where the sender has useful work
before confirming delivery.

Parent directive (score {score:.2f}):
{parent}
Feedback: {feedback}
Archive inspirations:
{inspirations}
Meta-recommendations: {recommendations}
Phase: {phase} (explore -> propose a structurally different strategy;
exploit -> refine one dimension or tunable of the parent).
"""

GIN_CONTEXT = ("PALLAS_RDMA (device-initiated): one persistent kernel "
               "stores straight into a peer rank's receive buffer through "
               "the per-rank pointer table; each edge has a flag word that "
               "the sender bumps with a release store after its data and "
               "the receiver spins on with an acquire load; transfers may "
               "overlap kernel compute. Rules: every wait must be matched "
               "by a flag the sender raises; a buffer slot may be reused "
               "only after the downstream reader acknowledges it.")
XLA_CONTEXT = ("XLA_COLLECTIVE (graph-level): host-issued collectives "
               "between kernel launches are barrier-semantic; overlap "
               "requires dependence-free program structure (STREAM_SPLIT).")


class LLMMutator(MutationOperator):
    """Paper-faithful prompt assembly; delegates generation to ``llm_fn``
    (str -> str). Offline containers use HeuristicMutator instead."""

    def __init__(self, llm_fn=None, temperature_explore=1.0,
                 temperature_exploit=0.2):
        self.llm_fn = llm_fn
        self.t_hi = temperature_explore
        self.t_lo = temperature_exploit

    def build_prompt(self, ctx: MutationContext) -> str:
        parent = ctx.parent
        space = "\n".join(f"  {k}: {v}" for k, v in DIMENSIONS.items())
        api = GIN_CONTEXT if parent.directive.backend != "XLA_COLLECTIVE" \
            else XLA_CONTEXT
        insp = "\n".join(c.directive.render() for c in ctx.archive_samples) \
            or "(none)"
        return PROMPT_TEMPLATE.format(
            space=space,
            hardware=getattr(ctx.hardware, "topology_summary", "(unknown)"),
            api_context=api, score=parent.score, parent=parent.directive.render(),
            feedback=(parent.result.diagnostic if parent.result else ""),
            inspirations=insp, recommendations=ctx.recommendations,
            phase=ctx.phase)

    def propose(self, ctx, rng):
        if self.llm_fn is None:
            raise RuntimeError(
                "LLMMutator requires an llm_fn (API access); this container "
                "is offline — use HeuristicMutator.")
        text = self.llm_fn(self.build_prompt(ctx))
        d = parse_directive(text, fallback=ctx.parent.directive)
        return d, "llm"


def parse_directive(text: str, fallback: Directive) -> Directive:
    """Parse a rendered directive block back into a Directive."""
    kw = {}
    tun = dict(fallback.tunables)
    for line in text.splitlines():
        parts = line.strip().split("=")
        if len(parts) != 2:
            continue
        k = parts[0].strip().split()[-1]
        v = parts[1].strip()
        if k in DIMENSIONS:
            kw[k] = int(v) if k == "contexts" else v
        elif k and line.strip().startswith("tunable"):
            name = line.strip().split()[1]
            try:
                tun[name] = int(v)
            except ValueError:
                pass
    return dataclasses.replace(fallback, **kw,
                               tunables=tuple(sorted(tun.items())))
