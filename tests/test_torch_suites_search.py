"""The port's telemetry and search-scale suites (``repro_torch.suites``)
against the reference's checked-in artifacts, on the CPU.

Run with the reference's hardware context (``V5E``), the port's searches
regenerate ``BENCH_search.json`` and ``BENCH_search_scale.json`` (the
comparison ``tests/test_multidevice.py`` makes of the reference's own
suites). The scores are modeled l3 costs, so the artifacts are
deterministic; l2 runs the kernels' plain versions at each workload's
verification size, which decides no score.

``BENCH_search_scale.json`` is equal field for field under this
interpreter's ``sum``. ``BENCH_search.json`` is equal only under the left
fold that ``sum`` was before Python 3.12 (``common.left_fold_sum``): from
3.12 ``sum`` adds floats with compensation, and the cost model's
``CostBreakdown.total`` and the telemetry's mean scores are such sums. The
reference itself gives the port's numbers on this interpreter (its cost
model and its ``SearchTelemetry`` are run on the same records below), so
under the interpreter's own ``sum`` the test pins the seven fields that
move, each by its last bits, and holds every other field equal.
"""
import json
import math

import pytest
import torch

from repro.core.design_space import Directive as JD
from repro.core.hardware import V5E as JV5E
from repro.core.hardware import HardwareContext as JHW
from repro.core.telemetry import EvalRecord as JEvalRecord
from repro.core.telemetry import SearchTelemetry as JSearchTelemetry
from repro.workloads.gemm_allgather import GemmAllGather as JGA
from repro_torch.core.hardware import V5E
from repro_torch.core.telemetry import EvalRecord
from repro_torch.suites import common, search_scale, telemetry
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = common.REPO_ROOT
# the fields of BENCH_search.json that Python 3.12's compensated ``sum``
# moves: the score of generations 1, 5 and 6 (one cost, whose segments add
# up to another last bit under it) and the means that hold it
MOVED_BY_SUM = ['.generations[1].best_score', '.generations[1].mean_score',
                '.generations[5].best_score', '.generations[5].mean_score',
                '.generations[6].best_score', '.generations[6].mean_score',
                '.islands[0].mean_score']


@pytest.fixture(scope="module")
def one_thread_module():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tel_v5e(tmp_path_factory, one_thread_module):
    return telemetry.run("cpu", chip=V5E, out=tmp_path_factory.mktemp(
        "tel") / "BENCH_search.json")


def test_telemetry_artifact_equals_checked_in_under_left_fold(tmp_path):
    with common.left_fold_sum():
        got = telemetry.run("cpu", chip=V5E,
                            out=tmp_path / "BENCH_search.json")
    want = common.read_json(ROOT / "BENCH_search.json")
    assert common.diff(got["artifact"], want) == []
    assert got["artifact"] == want
    assert json.loads((tmp_path / "BENCH_search.json").read_text()) == want


def test_telemetry_artifact_pinned_under_the_interpreters_sum(tel_v5e):
    got = tel_v5e["artifact"]
    want = common.read_json(ROOT / "BENCH_search.json")
    moved = common.diff(got, want)
    assert moved == MOVED_BY_SUM
    for path in moved:
        g, w = _at(got, path), _at(want, path)
        assert g != w and abs(g - w) <= 4 * math.ulp(w), (path, g, w)


def _at(obj, path):
    for part in path.strip(".").replace("]", "").replace("[", ".").split("."):
        obj = obj[int(part)] if part.isdigit() else obj[part]
    return obj


def test_telemetry_suite_checks(tel_v5e):
    assert tel_v5e["evals"] == 7
    assert tel_v5e["quarantine"]["quarantined"] is True
    assert tel_v5e["quarantine"]["rejection"] == "quarantine"
    assert 1.5 <= tel_v5e["quarantine"]["elapsed_s"] < 10.0
    assert set(tel_v5e["timelines"]) == {"gemm_allgather", "moe_dispatch",
                                         "ring_attention", "kv_transfer"}
    rows = tel_v5e["probes"]
    assert [(r["fused"], r["counter"], r["contexts"]) for r in rows] \
        == list(telemetry.PROBE_POINTS)
    assert all("probe" in r and "divergence" not in r for r in rows)
    assert [r["probe"]["rounds"] for r in rows] == [6, 6, 3]


def _reference_hw():
    return JHW(chip=JV5E, mesh_shape=(4,), mesh_axes=("x",), chips_per_pod=4,
               n_chips=4, has_dcn=False)


def test_eval_records_round_trip_against_the_reference(tmp_path):
    """Every record of the port's search, without its ``device`` (a field
    the reference's record lacks), reads into the reference's
    ``EvalRecord`` and back to the same row; the reference's cost model
    prices each directive to the port's model ms and score; and the
    reference's ``SearchTelemetry`` aggregates the rows to the port's
    payload."""
    mesh = telemetry.VirtualMesh(4, device="cpu")
    hw = telemetry.extract_hardware_context(mesh, V5E)
    res, _ = telemetry.search(mesh, hw)
    jw, jhw = JGA(**telemetry.SHAPE), _reference_hw()
    jtel = JSearchTelemetry(res.telemetry.workload)
    for rec in res.telemetry.records:
        d = rec.to_dict()
        assert d.pop("device") == "cpu"
        jrec = JEvalRecord.from_json(json.dumps(d))
        assert jrec.to_dict() == d
        back = EvalRecord.from_json(jrec.to_json())
        assert back.to_dict() == dict(d, device="")
        assert EvalRecord.from_json(rec.to_json()) == rec
        jtel.observe(jrec)
    for cand in res.db.records:
        assert cand.result.level == 3
        t = jw.analytic_cost(JD(**cand.directive.as_dict()), jhw) * 1e3
        assert t == cand.result.t_model_ms
        assert 10000.0 / (1.0 + t) == cand.score
    for g, cov in res.telemetry.coverage.items():
        jtel.note_coverage(g, cov)
    jtel.note_scale(**res.telemetry.scale)
    meta = {"shape": "x"}
    assert jtel.payload(meta) == res.telemetry.payload(meta)


@pytest.fixture(scope="module")
def scale_v5e(tmp_path_factory, one_thread_module):
    return search_scale.run("cpu", chip=V5E, out=tmp_path_factory.mktemp(
        "scale") / "BENCH_search_scale.json")


def test_search_scale_artifact_equals_checked_in(scale_v5e):
    want = common.read_json(ROOT / "BENCH_search_scale.json")
    assert common.diff(scale_v5e["artifact"], want) == []
    assert scale_v5e["artifact"] == want
    assert json.loads(open(scale_v5e["out"]).read()) == want


def test_search_scale_payoffs_at_least_2x(scale_v5e):
    ws, tr = scale_v5e["artifact"]["warm_start"], \
        scale_v5e["artifact"]["transfer"]
    assert ws["warm_fresh_evals_to_best"] <= ws["cold_evals_to_best"] // 2
    assert tr["transfer_fresh_evals_to_best"] \
        <= tr["cold_evals_to_best"] // 2
    assert scale_v5e["transfer_gate"] == "met"
    assert scale_v5e["warm_payoff"] >= 2 and scale_v5e["transfer_payoff"] >= 2
    assert ws["cache_hits"] > 0 and tr["transferred_seeds"] > 0
    assert scale_v5e["batched_on_threads"] is True


def test_search_scale_on_the_h100_model(tmp_path):
    """Priced on the card's model the same searches run their checks; the
    transfer's cold search finds its best at its second evaluation, which
    leaves a 2x payoff no room, and the summary says so."""
    got = search_scale.run("cpu", out=tmp_path / "scale.json")
    art = got["artifact"]
    assert got["chip"] == "h100-sxm"
    assert art["schema"] == "bench-search-scale/v1"
    assert art["ring_parity"]["history_equal"]
    cold = art["transfer"]["cold_evals_to_best"]
    assert got["transfer_gate"] == (
        "met" if cold >= search_scale.MIN_COLD_FOR_PAYOFF else "no room")
    assert art["warm_start"]["warm_fresh_evals_to_best"] \
        <= art["warm_start"]["cold_evals_to_best"] // 2
    assert (tmp_path / "scale_store.json").exists()


def test_left_fold_sum_is_restored_and_folds_left():
    import builtins
    plain = builtins.sum
    xs = [1e16, 1.0, -1e16]
    with common.left_fold_sum():
        assert sum(xs) == (1e16 + 1.0) - 1e16
        assert sum([[1], [2]], []) == [1, 2]
    assert builtins.sum is plain


def test_suites_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (telemetry, search_scale):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run("cuda")
