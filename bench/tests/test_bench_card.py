"""The benchmark's check on the card, at each cell's own size: a run
through the port's kernels comes out correct, and a run with the control
in the program's place (the plain reference at TF32, through
``plant.plant``) comes out not correct, on three seeds. Each control run
prints the number it compared, the upper reading a limit in
``bench/checks/<cell>.json`` is set below. Run on the card:

    PYTHONPATH=src python -m pytest -q -s -m gpu bench/tests/test_bench_card.py
"""
import io
import json
import time

import pytest

import plant
from bench.lib import harness, spec as speclib
from conftest import ROOT

SPEC = speclib.Spec(ROOT)
CELLS = sorted(SPEC.cells)
CONTROL_SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def _run(cell, seed, device):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(ROOT, cell, seed, 1.0, False, device,
                          time.perf_counter(), out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_at_its_own_size(cuda_device, cell):
    res = _run(cell, 2**31 + 17, cuda_device)
    assert res["correct"], res["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(
        cuda_device, monkeypatch, cell, seed):
    plant.plant(monkeypatch, SPEC.config(SPEC.cell(cell))["layer"],
                "control")
    res = _run(cell, seed, cuda_device)
    for k, c in res["check"].items():
        print(f"\ncontrol {cell} seed {seed} {k} {c['value']!r} "
              f"limit {c['limit']!r}", flush=True)
    assert res["correct"] is False, res["check"]
    assert res["failed"] > 0
