"""Whole runs of each cell on the CPU at a tiny size, past the look for a
card: a sound run comes out correct, and a run whose timed path is broken
underneath comes out not correct, for each fault the cell can have and
for the control (the reference at TF32 in the program's place). And the
command itself on this CPU: it fails, with no fallback."""
import io
import json
import subprocess
import sys
import time

import pytest

from bench.lib import harness, spec as speclib
import plant
from conftest import ROOT

SPEC = speclib.Spec(ROOT)
CELLS = sorted(SPEC.cells)


def _cases():
    """(cell, layer, what) for every cell: a sound run, the control in
    the program's place, and each fault the cell can have (its kind's
    hooks, ``kinds/<layer>.py``, say which)."""
    for cell in CELLS:
        c = SPEC.cell(cell)
        layer = SPEC.config(c)["layer"]
        for what in ("sound", "control") \
                + tuple(plant.faults(layer, SPEC.traffic(c))):
            yield cell, layer, what


def _run(root, cell, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(root, cell, 2**31 + 99, 0.2, trace, "cpu",
                          time.perf_counter(), out=out, err=err)
    assert rc == 0
    assert err.getvalue().splitlines()[-1].startswith("check row_rel_err ")
    res = json.loads(out.getvalue().splitlines()[-1])
    assert list(res)[-1] == "check"
    return res


@pytest.mark.parametrize("cell,layer,what", list(_cases()))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            layer, what):
    if what != "sound":
        plant.plant(monkeypatch, layer, what)
    res = _run(tiny_root, cell)
    assert res["correct"] is (what == "sound"), res["check"]
    assert res["attempted"] > 0
    assert (res["failed"] == 0) is (what == "sound")


@pytest.mark.parametrize("cell", [c for c in CELLS if
                                  SPEC.config(SPEC.cell(c))["layer"] == "moe"])
def test_a_program_without_the_mixs_shared_expert_is_refused(
        tiny_root, monkeypatch, cell):
    """The mix says whether the layer has the shared expert; a program
    entry whose second stream disagrees is refused before any step."""
    from repro_torch.workloads import WORKLOADS
    entry = WORKLOADS[SPEC.traffic(SPEC.cell(cell))["entry"]]
    monkeypatch.setattr(entry, "second_stream", not entry.second_stream)
    with pytest.raises(ValueError, match="shared-expert stream"):
        _run(tiny_root, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_its_per_layer_metrics_as_it_can(tiny_root,
                                                            cell):
    res = _run(tiny_root, cell, trace=True)
    assert res["correct"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in res["device"] and "busy_s" in res["device"]
    # on the CPU no device operation ran: no device metric is written
    assert set(res["metrics"]) == {"host_ms_per_step"}


def test_the_command_fails_without_a_card():
    cell = CELLS[0]
    got = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", cell,
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode != 0
    assert not any(line.startswith("{") for line in got.stdout.splitlines())
    assert "CUDA card" in got.stderr
