"""How a cooperative launch's CTAs are split over its streams of work
(the ranks of ``moe_dispatch`` and ``ring_attention``): one each, the rest
in proportion to the work."""
from __future__ import annotations


def cta_split(grid, work):
    """``grid`` CTAs over streams of the given (integer) ``work``: one
    each, and the rest in proportion to the work, by largest remainder
    (ties to the earlier stream; all-zero work splits evenly). The counts
    sum to ``grid``, are even (within one) under equal work and monotone
    in it. Raises where ``grid`` cannot give every stream one CTA."""
    work = [int(w) for w in work]
    k = len(work)
    if k == 0 or any(w < 0 for w in work):
        raise ValueError(f"cta_split wants streams of work >= 0, got {work}")
    if grid < k:
        raise ValueError(f"a grid of {grid} CTAs cannot give {k} streams "
                         "one each")
    if not any(work):
        work = [1] * k
    spare, total = grid - k, sum(work)
    base = [spare * w // total for w in work]
    rest = sorted(range(k), key=lambda i: (-(spare * work[i] % total), i))
    for i in rest[:spare - sum(base)]:
        base[i] += 1
    return [1 + b for b in base]

