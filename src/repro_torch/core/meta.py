"""Meta-summarizer (paper Appendix K): every k generations, digest the recent
batch, update a persistent scratchpad of what worked / what failed, and emit
ranked recommendations injected into the mutation context — generation-over-
generation learning without touching the optimizer itself. Port copy of
``repro/core/meta.py``."""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.design_space import BACKENDS, DIMENSIONS, PLACEMENTS


@dataclass
class MetaSummarizer:
    every: int = 3
    scratchpad: dict = field(default_factory=lambda: {
        "tried_behaviors": {}, "dim_value_scores": {}, "fail_reasons": {}})
    recommendations: list = field(default_factory=list)
    digests: list = field(default_factory=list)

    def observe(self, cand):
        sp = self.scratchpad
        b = cand.directive.behavior
        cur = sp["tried_behaviors"].get(b, 0.0)
        sp["tried_behaviors"][b] = max(cur, cand.score)
        for dim in DIMENSIONS:
            v = getattr(cand.directive, dim)
            bucket = sp["dim_value_scores"].setdefault(dim, {}).setdefault(
                v, [0.0, 0])
            bucket[0] += cand.score
            bucket[1] += 1
        if cand.result and not cand.result.ok:
            reason = cand.result.diagnostic.split(":")[0]
            sp["fail_reasons"][reason] = sp["fail_reasons"].get(reason, 0) + 1

    def summarize(self, gen, db):
        """(i) digest, (ii) scratchpad update (continuous via observe),
        (iii) ranked recommendations for the next generation."""
        sp = self.scratchpad
        recent = [r for r in db.records if r.gen >= gen - self.every]
        ok = [r for r in recent if r.result and r.result.ok]
        digest = {
            "gen": gen,
            "evaluated": len(recent),
            "passed": len(ok),
            "best_recent": max((r.score for r in ok), default=0.0),
            "best_overall": db.best.score if db.best else 0.0,
            "behaviors_covered": len(sp["tried_behaviors"]),
        }
        self.digests.append(digest)
        recs = []
        # recommend untried promising behaviors (cross-pollination targets)
        best = db.best
        if best is not None:
            for p in PLACEMENTS:
                for b in BACKENDS:
                    key = (b, p, best.directive.completion)
                    if key not in sp["tried_behaviors"] \
                            and p != "DEFERRED":
                        recs.append({"kind": "try_behavior", "backend": b,
                                     "placement": p,
                                     "completion": best.directive.completion})
        # per-dimension winners: values with the best mean score
        for dim, vals in sp["dim_value_scores"].items():
            ranked = sorted(((s / max(1, n), v) for v, (s, n) in vals.items()),
                            reverse=True)
            if len(ranked) >= 2 and ranked[0][0] > 1.05 * ranked[1][0]:
                recs.append({"kind": "prefer", "dim": dim,
                             "value": ranked[0][1]})
        # dominant-bottleneck hint from the best candidate's diagnostics
        recs.append({"kind": "bottleneck", "which": "collective"})
        self.recommendations = recs[:8]
        return digest, self.recommendations
