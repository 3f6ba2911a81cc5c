"""The traffic generator: each mix repeats for a seed, differs across
seeds only in order, and keeps its laws."""
import pytest

from bench.lib import spec as speclib, traffic
from conftest import ROOT

SPEC = speclib.Spec(ROOT)
MIXES = sorted({w["traffic"] for w in SPEC.data["workloads"]})
BIG = 2**31 + 12345


@pytest.mark.parametrize("mix", MIXES)
def test_pool_repeats_per_seed_and_differs_across_seeds(mix):
    m = SPEC.traffic({"traffic": mix})
    a, b = traffic.pool(m, BIG), traffic.pool(m, BIG)
    assert a == b and len(a) == m["pool"]
    others = [traffic.pool(m, s) for s in (BIG + 1, BIG + 2, 3, 2**40)]
    key = lambda p: sorted(tuple(sorted(e.items())) for e in p)  # noqa: E731
    for o in others:
        assert key(o) == key(a)          # the same work in every seed
    varied = [name for name, law in m["params"].items()
              if "fixed" not in law]
    if varied:
        assert any(o != a for o in others)


def test_lognormal_quantiles():
    m = SPEC.traffic({"traffic": "prefill_handoff"})
    law = m["params"]["prompt_tokens"]["lognormal_quantiles"]
    Ts = sorted(e["prompt_tokens"] for e in traffic.pool(m, 1))
    assert all(law["min"] <= T <= law["max"] for T in Ts)
    assert Ts[len(Ts) // 2 - 1] < law["median"] < Ts[len(Ts) // 2]
    assert Ts == [757, 1305, 1775, 2242, 2731, 3260, 3845, 4506, 5272,
                  6179, 7288, 8698, 10595, 13382, 18209, 31395]
    # the pool's mean is the mean input length of Mooncake's trace
    assert round(sum(Ts) / len(Ts)) == 7590


def test_sample_keeps_one_step_of_each_entry():
    res = traffic.Reservoir(BIG)
    for i in range(1000):
        res.offer(i, i % 4, f"out{i}")
    kept = res.items()
    assert [j for _, j, _ in kept] == [0, 1, 2, 3]
    assert all(s % 4 == j and out == f"out{s}" for s, j, out in kept)
    again = traffic.Reservoir(BIG)
    for i in range(1000):
        again.offer(i, i % 4, f"out{i}")
    assert again.items() == kept
