"""The one traffic generator: a mix's parameter file -> the pool of step
inputs a run replays, and the seeded sample of steps it checks.

A mix (``bench/traffic/<mix>.json``) names ``pool``, the number of
distinct step inputs, and under ``params`` how each parameter of an entry
is drawn:

- ``{"fixed": v}``: every entry takes ``v``;
- ``{"permute": [v0, v1, ...]}``: one value an entry (as many values as
  entries), in an order drawn from the seed;
- ``{"lognormal_quantiles": {"median": m, "sigma": s, "min": a, "max":
  b}}``: the pool's quantiles of a log-normal length law (entry i at
  (i + 0.5) / pool), clipped to [a, b] and rounded, in an order drawn from
  the seed.

Every seed draws the same set of values and differs only in their order
and in the data the layer makes from the seed, so two seeds do the same
work. Steps replay the pool in turn: step i runs entry ``i % pool``.
"""
from __future__ import annotations

import math
import random
from statistics import NormalDist

SEED_MASK = 2**64 - 1


def rng(seed, stream):
    """A host generator for ``stream`` of ``seed`` (any whole number)."""
    return random.Random(f"{int(seed) & SEED_MASK}:{stream}")


def _values(spec, pool):
    (kind, arg), = spec.items()
    if kind == "fixed":
        return [arg] * pool, False
    if kind == "permute":
        if len(arg) != pool:
            raise ValueError(f"permute wants {pool} values, got {len(arg)}")
        return list(arg), True
    if kind == "lognormal_quantiles":
        law = NormalDist()
        vals = [min(arg["max"], max(arg["min"], round(
            arg["median"] * math.exp(arg["sigma"]
                                     * law.inv_cdf((i + 0.5) / pool)))))
                for i in range(pool)]
        return vals, True
    raise ValueError(f"unknown parameter law {kind!r}")


def directive(mix):
    """The mix's ``directive`` entry (the point of CUCo's design space
    the cell runs) as the port's ``Directive``."""
    from repro_torch.core.design_space import Directive
    spec = dict(mix["directive"])
    tunables = tuple(sorted(spec.pop("tunables", {}).items()))
    return Directive(**spec, tunables=tunables)


def pool(mix, seed):
    """The mix's pool: a list of ``mix["pool"]`` dicts, one value of each
    parameter an entry."""
    n = int(mix["pool"])
    draw = rng(seed, "traffic")
    entries = [{} for _ in range(n)]
    for name in sorted(mix["params"]):
        vals, shuffled = _values(mix["params"][name], n)
        if shuffled:
            draw.shuffle(vals)
        for entry, v in zip(entries, vals):
            entry[name] = v
    return entries


class Reservoir:
    """A sample of the window's outputs drawn from the seed as the steps
    come (the window's length is not known in advance): for each pool
    entry, one of its steps, each equally likely. Holds the offered
    outputs themselves, no copy, so the sample's memory is the same in
    every run of a cell: one output of each entry."""

    def __init__(self, seed):
        self.draw = rng(seed, "sample")
        self.seen = {}
        self.kept = {}          # entry -> (step, entry, output)

    def offer(self, step, entry, out):
        self.seen[entry] = self.seen.get(entry, 0) + 1
        if self.draw.randrange(self.seen[entry]) == 0:
            self.kept[entry] = (step, entry, out)

    def items(self):
        return [self.kept[j] for j in sorted(self.kept)]
