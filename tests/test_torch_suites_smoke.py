"""``chip_smoke.py``'s phase ``suites`` on the CPU: the five acceptance
suites of ``repro_torch.suites`` run as the card runs them (the reference's
context against the checked-in artifacts, then the card's model), with the
kernels' plain versions, and the phase's ``kernels``-line records are held
and timed at the workload suite's shapes."""
import os
import sys

import pytest

from repro_torch.suites import common
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_chip_smoke_suites_phase_on_the_cpu(tmp_path, capsys):
    counts, records = chip_smoke.phase_suites("cpu", small=True,
                                              root=tmp_path, iters=1)
    assert counts == {}                     # no kernel runs on the cpu
    assert [r["name"].split("/")[0] for r in records] == \
        list(dict.fromkeys(c[0] for c in chip_smoke.suite_record_cases()))
    for r in records:
        assert r["_path"] == "suites" and r["route"] == "cuda"
        assert r["max_abs_err"] <= 1e-4 and r["bound_ms"] > 0
        assert r["source"].startswith("src/repro_torch/csrc/")
    for name in ("BENCH_search.json", "BENCH_search_scale.json",
                 "BENCH_serving.json"):
        assert common.read_json(tmp_path / "v5e" / name) == \
            common.read_json(os.path.join(ROOT, name))
        assert (tmp_path / name).exists()
    verify = common.read_json(tmp_path / "BENCH_verify.json")
    assert verify["summary"]["gate"] in ("met", "missed")
    out = capsys.readouterr().out
    assert "equals the checked-in BENCH_serving.json" in out
    assert "suites verify:" in out and "suites search_scale (H100)" in out


def test_phase_suites_fails_on_a_differing_artifact(tmp_path, monkeypatch):
    """A regenerated artifact that differs from the checked-in one stops
    the phase."""
    from repro_torch.suites import serving
    real = serving.rows

    def off(hw, path):
        bench = real(hw, path)
        bench["rows"][0]["us_per_call"] += 1.0
        return bench
    monkeypatch.setattr(serving, "rows", off)
    with pytest.raises(SystemExit, match="BENCH_serving.json regenerated"):
        chip_smoke.phase_suites("cpu", small=True, root=tmp_path, iters=1)
