"""BENCHMARK.json against the benchmark's contract, and every file its
names lead to."""
import io
import json
import re
import time

import pytest

import plant
from bench.lib import harness, spec as speclib
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = speclib.Spec(ROOT)
DATA = SPEC.data


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["paths"] == ["bench"]
    assert DATA["command"] == ["python3", "bench/run.py"]
    assert isinstance(DATA["run_seconds"], int) \
        and 1 <= DATA["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in DATA[k]]
    assert all(NAME.match(n) for n in names)
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({(w["config"], w["traffic"]) for w in DATA["workloads"]}) \
        == len(DATA["workloads"])


def test_bounds():
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"] for m in DATA["end_to_end"]}
    for m in DATA["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(SPEC.cells)
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", sorted(SPEC.cells))
def test_each_cell_finds_its_files_by_name(cell):
    c = SPEC.cell(cell)
    config, mix, checks = SPEC.config(c), SPEC.traffic(c), SPEC.checks(c)
    speclib.module("layers", config["layer"]).Layer  # noqa: B018
    speclib.module("reference", config["layer"])
    kind = plant.hooks(config["layer"])      # the kind's test hooks
    assert {"entry", "pool", "params", "why"} | set(kind.MIX_KEYS) \
        <= set(mix)
    for k, lim in checks.items():
        # an exact comparison has the limit 0 and a lower reading of 0
        assert lim["lower"] < lim["limit"] < lim["upper"] \
            or lim["lower"] == lim["limit"] == 0 < lim["upper"], k
    for m in SPEC.end_to_end(c) + SPEC.per_layer(c):
        assert callable(SPEC.metric(m["name"]).read)
    names = {m["name"] for m in SPEC.end_to_end(c)}
    assert {"setup_s", "tokens_per_s"} <= names
    assert SPEC.per_layer(c)


@pytest.mark.parametrize("name", sorted(SPEC.configs))
def test_configuration_files(name):
    entry = SPEC.configs[name]
    assert entry["file"].startswith("bench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for k in entry["reduced"]:
        assert cfg["published"][k] != cfg[k], k
        assert not k.endswith(("_dim", "_rank", "_size")), k
    # the published precision, or float32 where that is the cut
    if "torch_dtype" in entry["reduced"]:
        assert cfg["torch_dtype"] == "float32"
    else:
        assert cfg["torch_dtype"] == cfg["published"]["torch_dtype"]


@pytest.mark.parametrize("cell", sorted(SPEC.cells))
def test_a_moe_mix_says_whether_the_layer_has_the_shared_expert(cell):
    c = SPEC.cell(cell)
    if SPEC.config(c)["layer"] == "moe":
        assert isinstance(SPEC.traffic(c)["shared_expert"], bool)


def test_an_added_cell_of_new_files_only_is_found_and_runs(tiny_root):
    """A cell made of a new mix file, a new checks file and an entry in
    BENCHMARK.json runs with no edit to any file that was there."""
    mix = json.loads((tiny_root / "bench/traffic/prefill_skew.json")
                     .read_text())
    mix["params"]["skew"] = {"permute": [1.5, 2.5, 3.5, 4.5]}
    (tiny_root / "bench/traffic/prefill_mild.json").write_text(
        json.dumps(mix))
    checks = (tiny_root / "bench/checks/deepseek-v3-moe.prefill_skew.json")
    (tiny_root / "bench/checks/deepseek-v3-moe.prefill_mild.json") \
        .write_text(checks.read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "deepseek-v3-moe.prefill_mild",
                               "config": "deepseek-v3-moe",
                               "traffic": "prefill_mild", "chips": 1,
                               "why": "milder skew"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = io.StringIO()
    rc = harness.run_cell(tiny_root, "deepseek-v3-moe.prefill_mild", 7,
                          0.2, False, "cpu", time.perf_counter(), out=out,
                          err=io.StringIO())
    assert rc == 0
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] and set(res["metrics"]) == {
        "tokens_per_s", "step_p95_ms", "peak_mem_gib", "setup_s"}

