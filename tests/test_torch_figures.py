"""The port's paper figures (``repro_torch.figures``) against the
reference's ``benchmarks/``, on the CPU.

* The modeled rows of fig3, fig4 (n_dev 2 and 8), fig5, fig6 and table5
  on the reference's ``V5E`` context equal the reference's ``run()`` row
  for row: names in order, ``derived`` strings, and each us within 1e-12
  relative.
* The reference's own orderings (``tests/test_ring_points.py``,
  ``test_collective_points.py``, ``test_expert_points.py``) hold on the
  port's ``V5E`` rows; on the ``H100`` model the same orderings are
  printed, not asserted.
* With ``measure`` at the test cut (``small``) every point ``check``
  accepts gets its ``_card`` row, held to the workload's oracle.
* ``write_rows`` writes the reference's bytes; ``roofline_cells`` reads a
  port dry-run artifact to the reference's rows; ``python -m
  repro_torch.figures.run --device cpu --small`` prints every module's
  rows; ``chip_smoke.py``'s phase ``figures`` runs at the test cut.
"""
import importlib
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.core.hardware import H100, V5E
from repro_torch.figures import common
from repro_torch.figures import roofline_cells as t_roofline
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

FIGURES = {"fig3": ("fig3_flash_attention", {}),
           "fig4_n2": ("fig4_moe_skew", {"n_dev": 2}),
           "fig4_n8": ("fig4_moe_skew", {"n_dev": 8}),
           "fig5": ("fig5_kv_transfer", {}),
           "fig6": ("fig6_gemm_allgather", {}),
           "table5": ("table5_moe_phases", {})}
# the _card rows each figure gives: the points check accepts, per shape
# (fig3's cuco is PER_PEER, which the ring's check rejects; fig6's dcn
# rows stay modeled; table5 measures its four totals)
MEASURED = {"fig3": 4 * 3, "fig4_n2": 4 * 8, "fig4_n8": 4 * 8,
            "fig5": 6 * 2, "fig6": 3 * 4, "table5": 4}


def port(name):
    mod, kw = FIGURES[name]
    return importlib.import_module(f"repro_torch.figures.{mod}"), kw


def reference(name):
    mod, kw = FIGURES[name]
    return importlib.import_module(f"benchmarks.{mod}").run(**kw)


@pytest.mark.parametrize("name", FIGURES)
def test_modeled_rows_equal_reference(name):
    mod, kw = port(name)
    got = mod.run("cpu", chip=V5E, measure=False, **kw)
    want = reference(name)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    for (n, g, _), (_, w, _) in zip(got, want):
        assert math.isclose(g, w, rel_tol=1e-12, abs_tol=0.0), n


def _by_name(rows):
    return {n: us for n, us, _ in rows}


def ring_and_ga_order(rows, prefix):
    r = _by_name(rows)
    return r[prefix + "flux"] < r[prefix + "deferred"] < r[prefix + "host"]


@pytest.mark.parametrize("chip", [V5E, H100], ids=["v5e", "h100"])
def test_reference_orderings(chip):
    """fig3 and fig6: flux < deferred < host (at the reference's rows,
    seq 4096 hd 64 and 4096 ici); fig4 at n 2 and 8: DeepEP tight and FLUX
    under host at every skew. Asserted on V5E; printed on the H100 model
    with every shape's outcome."""
    from repro_torch.figures import (fig3_flash_attention, fig4_moe_skew,
                                     fig6_gemm_allgather)
    fig3 = fig3_flash_attention.run("cpu", chip=chip, measure=False)
    fig6 = fig6_gemm_allgather.run("cpu", chip=chip, measure=False)
    held = {}
    for seq in (4096, 8192):
        for hd in (32, 64):
            p = f"fig3/ring_attn_seq{seq}_hd{hd}_"
            held[p] = ring_and_ga_order(fig3, p)
    for size in (2048, 4096, 8192):
        for link in ("ici", "dcn"):
            p = f"fig6/gemm_ag_{size}_{link}_"
            held[p] = ring_and_ga_order(fig6, p)
    for n in (2, 8):
        r = _by_name(fig4_moe_skew.run("cpu", chip=chip, measure=False,
                                       n_dev=n))
        for skew in (2, 3, 4, 5):
            p = f"fig4/moe_skew{skew}_"
            held[f"n{n} {p}"] = (r[p + "deepep_tight"] < r[p + "host"]
                                 and r[p + "flux"] < r[p + "host"])
    print(f"{chip.name}: " + "; ".join(f"{k} {v}" for k, v in held.items()))
    if chip is V5E:
        assert held["fig3/ring_attn_seq4096_hd64_"]
        assert held["fig6/gemm_ag_4096_ici_"]
        assert all(v for k, v in held.items() if k.startswith("n"))


@pytest.mark.parametrize("name", FIGURES)
def test_measured_rows_on_the_cpu(name):
    """Every point check accepts gets a ``_card`` row after its modeled
    row, held to the oracle (the run raises otherwise), and the modeled
    rows stay the ``measure=False`` rows."""
    mod, kw = port(name)
    rows = mod.run("cpu", small=True, iters=1, **kw)
    card = [r for r in rows if r[0].endswith("_card")]
    assert len(card) == MEASURED[name]
    assert [r for r in rows if not r[0].endswith("_card")] == \
        mod.run("cpu", measure=False, **kw)
    names = [r[0] for r in rows]
    model = _by_name(rows)
    for n, us, derived in card:
        assert names[names.index(n) - 1] == n[:-len("_card")]
        # the card is held against the model of its own modeled row
        assert f"h100_model={model[n[:-len('_card')]]:.3f}us " in derived
        assert us > 0 and "card=cpu" in derived and "small: " in derived
        err = float(derived.split("max_abs_err=")[1].split()[0])
        assert err <= (0.1 if "i8" in n or n.startswith("table5") else 2e-3)
        lo, hi = map(float, common.RANGE.search(derived).groups())
        assert 0 < lo - 1e-3 <= us <= hi + 1e-3    # printed to 1e-3 us
    order = common.orderings(rows, mod.POINT_NAMES)
    assert sum(len(mo) for _, mo, _, _ in order) == MEASURED[name]
    assert {v for *_, v in order} <= {"matches", "differs", "unresolved"}


@pytest.mark.parametrize("card,verdict", [
    ({"a": (1.0, 0.9, 1.1), "b": (2.0, 1.9, 2.1)}, "matches"),
    ({"a": (2.0, 1.9, 2.1), "b": (1.0, 0.9, 1.1)}, "differs"),
    ({"a": (1.2, 0.9, 1.5), "b": (1.1, 1.0, 1.3)}, "unresolved"),
], ids=["matches", "differs", "unresolved"])
def test_orderings_verdict(card, verdict):
    """The model puts a ahead of b; the card's medians and ranges decide
    whether its order matches, differs, or swaps inside the calls'
    spread."""
    rows = []
    for p, model in (("a", 1.0), ("b", 2.0)):
        us, lo, hi = card[p]
        rows += [(f"f/x_{p}", model, ""),
                 (f"f/x_{p}_card", us, f"range={lo:.3f}-{hi:.3f}us")]
    [(group, mo, me, got)] = common.orderings(rows, ("a", "b"))
    assert (group, mo, got) == ("f/x", ["a", "b"], verdict)
    assert me == sorted("ab", key=lambda p: card[p][0])


def test_small_cut_lists_what_it_cuts():
    kw, cut = common.small_kw("ring_attention",
                              dict(n_dev=4, BH=96, seq=8192, hd=32))
    assert kw == dict(n_dev=4, BH=8, seq=128, hd=32)
    assert cut == "BH 96->8, seq 8192->128"


def test_write_rows_bytes_equal_reference(tmp_path):
    from benchmarks.common import write_rows as ref_write_rows
    mod, kw = port("fig4_n2")
    rows = mod.run("cpu", small=True, iters=1, **kw)
    common.write_rows(tmp_path / "port.json", rows)
    ref_write_rows(tmp_path / "ref.json", rows)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    out = tmp_path / "fig4.json"
    assert mod.run("cpu", chip=V5E, measure=False, out=out, **kw) == \
        [tuple(r) for r in reference("fig4_n2")]
    assert json.loads(out.read_text())["schema"] == "bench-rows/v1"


@pytest.fixture(scope="module")
def dryrun_artifacts(tmp_path_factory):
    """One port dry-run cell and a skipped one, as ``launch.dryrun``
    writes them."""
    from repro_torch.launch import dryrun
    out = tmp_path_factory.mktemp("dryrun_torch")
    for arch, shape in (("llama3.2-1b", "decode_32k"),
                        ("llama3.2-1b", "long_500k")):
        d = dryrun.run_cell(arch, shape, False, verbose=False)
        (out / f"{arch}__{shape}__single.json").write_text(json.dumps(d))
    return out


def test_roofline_cells_equal_reference(dryrun_artifacts, monkeypatch):
    from benchmarks import roofline_cells as ref_roofline
    monkeypatch.setattr(ref_roofline, "ARTIFACTS", dryrun_artifacts)
    got = t_roofline.run("cpu", artifacts=dryrun_artifacts)
    assert got == ref_roofline.run()
    assert [r[0] for r in got] == ["roofline/llama3.2-1b__decode_32k__16x16"]
    monkeypatch.setattr(t_roofline, "ARTIFACTS", dryrun_artifacts)
    assert t_roofline.run("cpu") == got


def test_run_module_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.figures.run", "--device", "cpu",
         "--small", "--iters", "1", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    for prefix in ("fig3/", "fig4/", "fig5/", "fig6/", "table5/", "fig9/",
                   "fig10/", "fig11/", "fig12/", "fig13/", "fig9_13/"):
        assert any(line.startswith(prefix) for line in lines[1:]), prefix
    assert "ERROR" not in proc.stdout
    for table in ("fig3_flash_attention", "fig4_moe_skew",
                  "fig5_kv_transfer", "fig6_gemm_allgather",
                  "table5_moe_phases", "fig9_13_ablations",
                  "roofline_cells"):
        assert json.loads((tmp_path / f"{table}.json").read_text())[
            "schema"] == "bench-rows/v1"
    assert "cuco: not measured: fused ring kernels" in proc.stderr


def test_chip_smoke_figures_phase_on_the_cpu(tmp_path, dryrun_artifacts,
                                            capsys):
    counts, records = chip_smoke.phase_figures(
        "cpu", small=True, root=tmp_path, iters=1,
        artifacts=dryrun_artifacts)
    assert counts == {}                     # no kernel runs on the cpu
    assert [(r["name"].split("/")[0], r["_path"]) for r in records] == \
        [(c[0], "figures") for c in chip_smoke.figure_record_cases()]
    for r in records:
        assert r["route"] == "cuda" and r["bound_ms"] > 0
        assert r["max_abs_err"] <= 1e-3 and r["library_ms"] > 0
        assert r["source"].startswith("src/repro_torch/csrc/")
    for _, _, table in chip_smoke.FIGURE_RUNS:
        assert (tmp_path / f"{table}.json").exists()
    out = capsys.readouterr().out
    assert "figure order fig4/moe_skew5:" in out
    assert "figure roofline_cells: 1 cells" in out
    assert "figure fig9_13/wall_per_candidate_card" in out
