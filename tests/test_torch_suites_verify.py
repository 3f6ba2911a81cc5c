"""The port's verify and workload suites (``repro_torch.suites``), on the CPU.

The verify suite's lint rows (workload, point, status and detail; each
mutation class with its expected and first code) equal the reference's
``tools/schedule_lint.py`` rows, run in-process (its l0 is pure Python),
and its timed l0 rejections cover the reference's ``mutation_corpus``
class for class. The l0 / l2 ratio is a reading: the payload carries it
beside the reference's 0.1 gate and says whether the gate was met. The
workload suite holds every workload's host baseline and directive builds
against its oracle at the reference suite's shapes.
"""
import importlib.util
import os

import pytest
import torch

from repro.core.verify import mutation_corpus as reference_corpus
from repro_torch.suites import verify, workload
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _reference_lint():
    spec = importlib.util.spec_from_file_location(
        "reference_schedule_lint", os.path.join(ROOT, "tools",
                                                "schedule_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "elapsed_ms"} for r in rows]


# the port's workloads that the reference package does not have: LongCat's
# ScMoE double-layer (workloads/scmoe.py)
OWN_WORKLOADS = {"scmoe_step"}


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield verify.run("cpu", out=tmp_path_factory.mktemp("verify")
                         / "BENCH_verify.json")
    finally:
        torch.set_num_threads(before)


def test_lint_rows_equal_the_references(suite):
    ref = _reference_lint()
    prows, pfail = ref.lint_points(quiet=True)
    mrows, mfail = ref.lint_mutations(quiet=True)
    assert not pfail and not mfail
    assert _strip([r for r in suite["points"]
                   if r["workload"] not in OWN_WORKLOADS]) == _strip(prows)
    assert _strip(suite["mutations"]) == _strip(mrows)
    assert [(r["class"], r["expect"], r["first"], r["caught"])
            for r in suite["mutations"]] == [
        (r["class"], r["expect"], r["first"], r["caught"]) for r in mrows]
    assert suite["n_points_ok"] >= 10


def test_lint_rows_of_the_ports_own_workloads_are_clean(suite):
    own = [r for r in suite["points"] if r["workload"] in OWN_WORKLOADS]
    assert {r["workload"] for r in own} == OWN_WORKLOADS
    assert all(r["status"] in ("ok", "vacuous") for r in own)
    assert sum(r["status"] == "ok" for r in own) == 3


def test_l0_rejections_cover_the_reference_corpus(suite):
    rows = suite["artifact"]["l0_rejections"]
    assert [(r["class"], r["code"]) for r in rows] == [
        (e["cls"], e["expect"]) for e in reference_corpus()]
    assert all(r["l0_ms"] > 0 for r in rows)


def test_l2_points_and_the_gate_reading(suite):
    art = suite["artifact"]
    assert art["schema"] == "verify-bench/v1"
    points = [(r["workload"], r["point"]) for r in art["l2_interpret"]]
    assert points == [(w, p) for w, _, ps in verify.POINTS for p in ps]
    assert all(r["level"] == 3 and r["l2_ms"] > 0
               for r in art["l2_interpret"])
    s = art["summary"]
    assert s["ratio"] == s["l0_mean_ms"] / s["l2_mean_ms"]
    assert s["gate_ratio"] == 0.1 and s["l2_device"] == "cpu"
    assert s["gate"] == ("met" if s["ratio"] < 0.1 else "missed")


def test_workload_suite_holds_every_build_to_its_oracle():
    got = workload.run("cpu")
    names = [name for name, _ in got["workloads"]]
    assert names == [c[0] for c in workload.cases()]
    for (name, errs), (_, _, directives, _) in zip(got["workloads"],
                                                   workload.cases()):
        assert len(errs) == len(directives) + 1, name     # + host baseline
        assert all(e >= 0 for e in errs.values())


def test_workload_suite_catches_a_wrong_build(monkeypatch):
    """A build that is off by more than the tolerance fails the suite."""
    from repro_torch.suites.common import SuiteFailure
    from repro_torch.workloads.gemm_allgather import GemmAllGather
    real = GemmAllGather.build

    def off(self, d, mesh):
        fn = real(self, d, mesh)
        return lambda *xs: fn(*xs) * 1.01
    monkeypatch.setattr(GemmAllGather, "build", off)
    name, n, directives, kw = workload.cases()[-1]
    with pytest.raises(SuiteFailure, match="gemm_allgather"):
        workload.check(name, n, directives, kw, torch.device("cpu"))
