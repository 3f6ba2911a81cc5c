"""The port's fig9-13 ablations (``repro_torch.figures.fig9_13_ablations``)
against the reference's (``benchmarks/fig9_13_ablations.py``), on the CPU.

The reference's search cannot run its kernels here (at more than one rank
they fail on this JAX, ROADMAP queue 3), so both packages run under one
stub: a candidate's build returns its first input, which l1 lowers (the
reference) or loads (the port), and l2 returns the evaluator's expected
output, so no Pallas kernel lowers or runs and
every candidate past l0 passes l2. l0 (the schedule verifier) and l3 (the
cost model on ``V5E``) stay real. The reference runs in a 4-device
subprocess at a lowered ``GENS``; the rows must be equal. Then the port's
fig9-13 runs once more through its real cascade (the ring's plain version
at l2): no candidate fails l1 or l2, and its rows equal the stubbed
run's.
"""
import json
import os

import numpy as np
import pytest

from repro_torch.core import cascade as tcas
from repro_torch.core.hardware import V5E
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.figures import fig9_13_ablations as fig
from repro_torch.workloads.ring_attention import RingAttention
from torch_port_helpers import run_jax_devices

GENS = 4
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

REFERENCE = f"""
import json, sys
import numpy as np
sys.path.insert(0, {REPO!r})
from repro.core import cascade
from repro.launch.mesh import make_mesh
from repro.workloads.ring_attention import RingAttention
import benchmarks.fig9_13_ablations as fig
fig.GENS = int(np.load(sys.argv[1])["gens"])
cascade.CascadeEvaluator._run_l2 = lambda self, jfn: self.expected
RingAttention.build = lambda self, d, mesh: lambda q, k, v: q
rows = fig.run(make_mesh((4,), ("x",)))
np.savez(sys.argv[2], rows=np.array(json.dumps(rows)))
"""


def _port_rows(monkeypatch, stub):
    monkeypatch.setattr(fig, "GENS", GENS)
    if stub:
        monkeypatch.setattr(tcas.CascadeEvaluator, "_run_l2",
                            lambda self, fn: self.expected)
        monkeypatch.setattr(RingAttention, "build",
                            lambda self, d, mesh: lambda q, k, v: q)
    return fig.run("cpu", chip=V5E, mesh=VirtualMesh(4, device="cpu"),
                   measure=False)


@pytest.fixture(scope="module")
def reference_rows(tmp_path_factory):
    out = run_jax_devices(REFERENCE, {"gens": np.array(GENS)},
                          str(tmp_path_factory.mktemp("fig9_13")))
    return [tuple(r) for r in json.loads(str(out["rows"]))]


def test_fig9_13_equal_reference_under_the_stub(reference_rows,
                                                monkeypatch):
    got = _port_rows(monkeypatch, stub=True)
    assert [r[0] for r in got] == [r[0] for r in reference_rows]
    assert got == reference_rows


def test_fig9_13_through_the_real_cascade(monkeypatch):
    """The port's cascade as it runs (the ring's plain version at l2):
    no candidate fails l1 or l2, and the rows equal the stubbed run's."""
    with monkeypatch.context() as m:
        stubbed = _port_rows(m, stub=True)
    records = []
    plain_record = tcas.CascadeEvaluator._record

    def keep(self, cand, res, levels, **kw):
        out = plain_record(self, cand, res, levels, **kw)
        records.append((repr(cand.directive), res.rejection))
        return out

    monkeypatch.setattr(tcas.CascadeEvaluator, "_record", keep)
    real = _port_rows(monkeypatch, stub=False)
    assert records
    assert [r for r in records if r[1].startswith(("l1", "l2"))] == []
    assert real == stubbed
