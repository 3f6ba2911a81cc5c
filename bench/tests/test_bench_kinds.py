"""Layer kinds added by new files only. A toy kind whose step makes four
launches, written into a tiny copy of the benchmark as a configuration, a
mix, a checks file, ``layers/``, ``reference/``, ``counts/`` and
``tests/kinds/`` files and entries in ``BENCHMARK.json``, runs sound, with
the control and with every fault of its hooks, through the copy's own
harness with no file of the copy edited. And the readers that count
launches read a step of 16 launches as one launch of the summed time."""
import importlib
import io
import json
import sys
import time

import pytest

import plant
from bench.lib import harness, spec as speclib
from bench.lib.trace import Trace
from bench.lib.window import Window

TOY = {
    "bench/configs/toy.json": {
        "source": "https://example.org/toy", "layer": "toy", "reduced": {},
        "published": {}, "torch_dtype": "float32", "width": 32},
    "bench/traffic/toy_copy.json": {
        "why": "toy", "entry": "kv_cache_shuttle", "pool": 3,
        "params": {"rows": {"permute": [40, 80, 120]}}},
    "bench/checks/toy.toy_copy.json": {
        "row_rel_err": {"limit": 0, "lower": 0, "upper": 1e-4}},
}

LAYER = '''
"""A toy layer kind: four pure copies through kv_cache_shuttle a step."""
import functools

import torch

from bench.counts import toy as counts
from bench.reference import common, toy as ref

BLOCKS = 4


class Layer:
    kernel = "kv_shuttle_kernel"

    def __init__(self, config, mix, entries, seed, device):
        self.dtype = config["torch_dtype"]
        self.w = int(config["width"])
        self.rows = [int(e["rows"]) for e in entries]
        g = torch.Generator(device=device).manual_seed(seed)
        self.x = [torch.randn((BLOCKS, 2, 2 * r, self.w), generator=g,
                              device=device) for r in self.rows]
        for x in self.x:
            x[:, 1] = 0
        self.steps = [functools.partial(self._step, x) for x in self.x]

    @staticmethod
    def _step(x):
        from repro_torch.kernels.kv_shuttle import kv_cache_shuttle
        return [kv_cache_shuttle(b) for b in x]

    def launches(self, j):
        return BLOCKS

    def tokens(self, j):
        return self.rows[j]

    def flops(self, j):
        return 0

    def nbytes(self, j):
        return counts.nbytes(BLOCKS, self.rows[j], self.w)

    def check(self, j, out):
        worst = 0.0
        for b, (k, v) in zip(self.x[j], out):
            n = k.shape[1]
            want = ref.copy(b[0])
            worst = max(worst, common.row_rel_err(k[1], want[:n]),
                        common.row_rel_err(v[1], want[n:]))
        return {"row_rel_err": worst}
'''

REFERENCE = '''
def copy(t):
    return t.clone()
'''

COUNTS = '''
def nbytes(blocks, rows, width):
    return 2 * blocks * 2 * rows * width * 4
'''

HOOKS = '''
import torch

from bench.reference import common

CONFIG = {"width": 8}
PARAMS = {"rows": {"permute": [4, 8, 12]}}
MIX_KEYS = ()
FAULTS = ("unchanged", "half", "altered")


def plant(monkeypatch, what):
    from repro_torch.kernels import kv_shuttle
    orig = kv_shuttle.kv_cache_shuttle

    def run(kv, **kw):
        k, v = (t.clone() for t in orig(kv, **kw))
        n = k.shape[1]
        if what == "control":
            k[1], v[1] = (common.tf32_round(t) for t in (k[1], v[1]))
        elif what == "unchanged":
            k.zero_(), v.zero_()
        elif what == "half":
            k[1, n // 2:] = 0
        elif what == "altered":
            v[1, -1] *= 1.001
        return k, v
    monkeypatch.setattr(kv_shuttle, "kv_cache_shuttle", run)
'''


def _add_toy(root):
    """The toy kind's files and entries, added to the copy at ``root``."""
    for rel, data in TOY.items():
        (root / rel).write_text(json.dumps(data))
    for rel, src in (("layers/toy.py", LAYER), ("reference/toy.py", REFERENCE),
                     ("counts/toy.py", COUNTS), ("tests/kinds/toy.py", HOOKS)):
        (root / "bench" / rel).write_text(src)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "bench/configs/toy.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": "toy.toy_copy", "config": "toy",
                               "traffic": "toy_copy", "chips": 1,
                               "why": "four launches a step"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def copy_as_bench(monkeypatch):
    """``use(root)``: the package ``bench`` imported from the copy at
    ``root`` until the test ends (the checkout's modules put back after
    it); returns the copy's harness."""
    before = set(sys.modules)

    def ours(name):
        return name == "bench" or name.startswith("bench.")

    def use(root):
        monkeypatch.syspath_prepend(str(root))
        for name in [m for m in sys.modules if ours(m)]:
            monkeypatch.delitem(sys.modules, name)
        return importlib.import_module("bench.lib.harness")
    yield use
    for name in [m for m in sys.modules if ours(m) and m not in before]:
        del sys.modules[name]


def test_a_kind_without_hooks_names_the_missing_file(tmp_path):
    with pytest.raises(speclib.SpecError,
                       match=r"add bench/tests/kinds/nokind\.py"):
        plant.hooks("nokind", tmp_path)


def test_a_toy_kind_of_new_files_only_runs_sound_control_and_faults(
        tiny_root, monkeypatch, copy_as_bench):
    from conftest import shrunk_copy
    _add_toy(tiny_root)
    small = tiny_root / "small"
    small.mkdir()
    shrunk_copy(small, tiny_root)       # the toy cut by its own hooks
    assert json.loads((small / "bench/configs/toy.json").read_text())[
        "width"] == 8
    # the copy's code is the checkout's, byte for byte, beside the toy's
    for p in (small / "bench").rglob("*.py"):
        if p.stem != "toy":
            assert p.read_bytes() == (plant.ROOT / p.relative_to(small)) \
                .read_bytes(), p
    run_cell = copy_as_bench(small).run_cell
    kind = plant.hooks("toy", small)
    for what in ("sound", "control") + kind.FAULTS:
        with monkeypatch.context() as m:
            if what != "sound":
                kind.plant(m, what)
            out = io.StringIO()
            assert run_cell(small, "toy.toy_copy", 2**31 + 3, 0.2, False,
                            "cpu", time.perf_counter(), out=out,
                            err=io.StringIO()) == 0
        res = json.loads(out.getvalue().splitlines()[-1])
        assert res["correct"] is (what == "sound"), (what, res["check"])
        assert (res["failed"] == 0) is (what == "sound")
    assert sys.modules["bench.layers.toy"].__file__ \
        == str(small / "bench/layers/toy.py")


class _OneLaunch:
    """A layer that states no launches: one a step."""
    kernel = "k"
    dtype = "bfloat16"

    def flops(self, j):
        return 0

    def nbytes(self, j):
        return 3_350_000_000       # 1 ms at the HBM peak


class _Launches(_OneLaunch):
    def __init__(self, n):
        self.n = n

    def launches(self, j):
        return self.n


MS = 1_000_000


def _ctx(per_step, monkeypatch, stated=None, steps=3):
    """Three steps 30 ms apart, each 4 ms of kernel time and 2 ms of
    wrapper calls, split into ``per_step`` launches and ``.call`` spans;
    the layer states ``stated`` launches a step (None: it says nothing)."""
    ops, log = [], []
    for i in range(steps):
        for n in range(per_step):
            t0 = (30 * i) * MS + n * 4 * MS // per_step
            ops.append(("k", t0, 4 * MS // per_step))
            log.append(("kv_shuttle.call", i * per_step + n, None, t0,
                        t0 + 2 * MS // per_step))
    from repro_torch.core import telemetry
    monkeypatch.setattr(telemetry, "spans", lambda: list(log))
    tr = Trace(ops=ops, spans=[("bench.step", 30 * i * MS, (30 * i + 20) * MS)
                               for i in range(steps)])
    layer = _OneLaunch() if stated is None else _Launches(stated)
    return harness.Context(layer=layer, window=Window(
        entries=[0] * steps, wall_s=0.1), setup_s=0.0, peak_bytes=0, trace=tr)


def test_sixteen_launches_a_step_read_as_one_of_the_summed_time(monkeypatch):
    host = speclib.Spec(plant.ROOT).metric("wrapper_host_ms_per_step")
    one = _ctx(1, monkeypatch)
    want = (one.roofline("k"), host.read(one))
    assert want == (pytest.approx(25.0), pytest.approx(2.0))
    many = _ctx(16, monkeypatch, stated=16)
    assert many.launches() == 48
    assert (many.roofline("k"), host.read(many)) == pytest.approx(want)
    many.trace.ops.pop()                # a launch short: nothing to read
    assert many.roofline("k") is None
    # a layer that states fewer launches than the trace holds: nothing
    for stated in (None, 15):
        other = _ctx(16, monkeypatch, stated=stated)
        assert other.roofline("k") is None and host.read(other) is None
