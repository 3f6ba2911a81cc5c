"""The benchmark's readers of the program's own trace
(``bench/metrics/{wrapper_host_ms_per_step,device_idle_in_wrapper,
*_wait_share,*_gemm_share}.py``) on hand-made contexts and logs, and a
whole traced run of each cell on the CPU at a tiny size, which still
prints its result with these metrics left out."""
import io
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.lib import harness, spec as speclib  # noqa: E402
from bench.lib.trace import Trace  # noqa: E402
from bench.lib.window import Window  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402

SPEC = speclib.Spec(ROOT)
SHARES = [("moe_kernel_wait_share", "moe_kernel", "wait"),
          ("moe_kernel_gemm_share", "moe_kernel", "gemm"),
          ("kv_shuttle_kernel_wait_share", "kv_shuttle_kernel", "wait"),
          ("kv_shuttle_kernel_gemm_share", "kv_shuttle_kernel", "gemm")]
NEW = ["wrapper_host_ms_per_step", "device_idle_in_wrapper",
       "scmoe_route_idle"] + [m for m, _, _ in SHARES]
MS = 1_000_000


@pytest.fixture(autouse=True)
def clean_trace():
    telemetry.reset()
    yield
    telemetry.reset()


def _read(name, ctx):
    return SPEC.metric(name).read(ctx)


def _ctx(steps=3, wall_s=0.1, ops=(), log=None, monkeypatch=None):
    """Three steps in a 100 ms window: ``bench.step`` spans at 0-20, 30-50
    and 60-80 ms, ``bench.drain`` at 90-100; ``log`` in place of the
    program's."""
    spans = [("bench.step", 30 * i * MS, (30 * i + 20) * MS)
             for i in range(steps)] + [("bench.drain", 90 * MS, 100 * MS)]
    if log is not None:
        monkeypatch.setattr(telemetry, "spans", lambda: list(log))
    tr = Trace(ops=list(ops), spans=spans)
    tr.busy_s = 0.0
    return harness.Context(layer=None, window=Window(
        entries=[0] * steps, wall_s=wall_s), setup_s=0.0, peak_bytes=0,
        trace=tr)


def _call(i, t0, t1, name="moe_dispatch.call"):
    """A call's log: the ``.call`` span of step i and its three children."""
    base = 30 * i * MS
    kids = [(name.replace("call", k), i + 1, name, base + t0 * MS,
             base + t1 * MS) for k in ("prepare", "alloc", "launch")]
    return kids + [(name, i + 1, None, base + t0 * MS, base + t1 * MS)]


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_where_nothing_was_recorded(name,
                                                         monkeypatch):
    ctx = _ctx()
    assert _read(name, ctx) is None            # an empty log, no counters
    assert _read(name, _ctx(log=[], monkeypatch=monkeypatch)) is None
    ctx.trace = None                           # an untraced run
    assert _read(name, ctx) is None
    # a program without the trace (the parent commit's): None, no raise
    for attr in ("spans", "cycle_share"):
        monkeypatch.delattr(telemetry, attr)
    assert _read(name, _ctx()) is None


def test_wrapper_host_ms_per_step(monkeypatch):
    log = [s for i in range(3) for s in _call(i, 1, 3)]
    log += [("serving.shared_add", 9, None, 30 * i * MS + 4 * MS,
             30 * i * MS + 5 * MS) for i in range(3)]
    # a call before the window (another run of the process) is not read
    log += [("moe_dispatch.call", 99, None, -50 * MS, -40 * MS)]
    got = _read("wrapper_host_ms_per_step",
                _ctx(log=log, monkeypatch=monkeypatch))
    assert got == pytest.approx(3.0)
    # a step whose call left no span: the count is off, nothing is read
    assert _read("wrapper_host_ms_per_step",
                 _ctx(log=log[4:], monkeypatch=monkeypatch)) is None


def test_device_idle_in_wrapper(monkeypatch):
    log = [s for i in range(3) for s in _call(i, 2, 10, "kv_shuttle.call")]
    # device busy 0-4, 6-40, 45-92 ms: the gap 4-6 lies in step 0's call
    # (2-10), 40-45 in no call (step 1's runs 32-40), so 2 ms of 100
    ops = [("k", 0, 4 * MS), ("k", 6 * MS, 20 * MS), ("k", 20 * MS, 20 * MS),
           ("k", 45 * MS, 47 * MS)]
    ctx = _ctx(ops=ops, log=log, monkeypatch=monkeypatch)
    ctx.trace.busy_s = 0.085
    got = _read("device_idle_in_wrapper", ctx)
    assert got == pytest.approx(2.0)
    assert got <= _read("device_idle", ctx)
    # no call span in the window: nothing to read
    assert _read("device_idle_in_wrapper", _ctx(
        ops=ops, log=log[:3], monkeypatch=monkeypatch)) is None


def test_scmoe_route_idle_runs_to_the_layers_kernel(monkeypatch):
    # each step: route 1-5 ms (its table read returns at 5), the call
    # 5-8; device busy 0-3 (router), idle 3-9, moe_kernel from 9 to 19,
    # idle 19-21, a fill 21-22: the route's idle is 3-9, 6 ms a step,
    # though the gap's midpoint (6) lies past the route span's end
    log, ops = [], []
    for i in range(3):
        base = 30 * i * MS
        log.append(("scmoe.route", 10 + i, None, base + MS, base + 5 * MS))
        log += _call(i, 5, 8)
        ops += [("gemm", base, 3 * MS), ("moe_kernel(MoeParams)",
                                         base + 9 * MS, 10 * MS),
                ("fill", base + 21 * MS, MS)]
    ctx = _ctx(ops=ops, log=log, monkeypatch=monkeypatch)
    assert _read("scmoe_route_idle", ctx) == pytest.approx(18.0)
    # a route with no kernel after it: only the gaps inside its span
    ctx = _ctx(ops=ops[:3], log=log[:1], monkeypatch=monkeypatch)
    ctx.trace.ops = [("gemm", 0, 2 * MS), ("fill", 4 * MS, MS)]
    assert _read("scmoe_route_idle", ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("name,kernel,bucket", SHARES)
def test_cycle_share_readers(name, kernel, bucket):
    with profile(activities=[ProfilerActivity.CPU]):
        acc = telemetry.kernel_counters(kernel, ("a", "b"), "cpu")
    # ctas, cycles, wait, gemm of each role: wait 30%, gemm 60% of 1000
    acc[0] = torch.tensor([8, 900, 250, 600])
    acc[1] = torch.tensor([1, 100, 50, 0])
    want = {"wait": 30.0, "gemm": 60.0}[bucket]
    assert _read(name, _ctx()) == pytest.approx(want)
    other = [m for m, k, _ in SHARES if k != kernel]
    assert all(_read(m, _ctx()) is None for m in other)


def _hooks(layer):
    """The test hooks of a layer kind (``bench/tests/kinds/<layer>.py``,
    found by ``bench/tests/plant.py::hooks``): its tiny widths and sizes."""
    plant = speclib.load_module(ROOT / "bench" / "tests" / "plant.py",
                                "bench_tests_plant")
    return plant.hooks(layer, ROOT)


def _tiny_copy(dest):
    """``BENCHMARK.json`` and ``bench/`` copied to ``dest`` at a size the
    CPU runs in a blink: each configuration and each cell's mix cut by its
    layer kind's hooks (``CONFIG``, ``PARAMS``), as the benchmark's own
    tests cut them."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    layers = {}
    for entry in SPEC.data["configs"]:
        path = dest / entry["file"]
        cfg = json.loads(path.read_text())
        cfg.update(_hooks(cfg["layer"]).CONFIG)
        path.write_text(json.dumps(cfg))
        layers[entry["name"]] = cfg["layer"]
    for cell in SPEC.data["workloads"]:
        path = dest / "bench" / "traffic" / f"{cell['traffic']}.json"
        mix = json.loads(path.read_text())
        params = _hooks(layers[cell["config"]]).PARAMS
        mix["params"].update({k: v for k, v in params.items()
                              if k in mix["params"]})
        path.write_text(json.dumps(mix))
    return dest


@pytest.mark.parametrize("cell", sorted(SPEC.cells))
def test_traced_cpu_run_prints_its_result(tmp_path, monkeypatch, cell):
    # other test files of this process load JAX, which the harness's guard
    # refuses (its own tests hold the guard); here the run itself is held
    monkeypatch.setattr(harness.guard, "forbidden_loaded", lambda: [])
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(_tiny_copy(tmp_path), cell, 2**31 + 7, 0.2, True,
                          "cpu", time.perf_counter(), out=out, err=err)
    assert rc == 0
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    # the CPU path launches no kernel: no wrapper call, no counter, no
    # device operation, so none of the program's metrics is written
    assert not set(res["metrics"]) & set(NEW)
    assert "host_ms_per_step" in res["metrics"]
