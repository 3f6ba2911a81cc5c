"""The benchmark's description and the files it names.

``BENCHMARK.json`` at the checkout's root lists configurations, cells and
metrics by name; everything that belongs to one of them sits in a file of
its own under ``bench/``, found here by that name:

- ``configs/<config>.json``: the configuration's sizes as run, with its
  ``source``, ``reduced`` and ``assumed`` keys and the layer kind
  (``layer``) whose plain reference is ``reference/<layer>.py``;
- ``traffic/<mix>.json``: the mix's parameters, read by ``lib/traffic.py``;
- ``checks/<cell>.json``: each number ``correct`` compares, with its limit
  and the two readings the limit was set from;
- ``metrics/<metric>.py``: the reader of one metric;
- ``layers/<layer>.py``: how a layer kind makes its operands, calls the
  program and holds its outputs to ``reference/<layer>.py``, with its
  FLOPs and bytes from ``counts/<layer>.py`` (and its test hooks in
  ``tests/kinds/<layer>.py``).

Adding a cell, a mix, a configuration, a metric or a layer kind adds
files and entries only; nothing here names one of them.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = "bench"


class SpecError(ValueError):
    pass


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (any file name: metric
    names may hold dots and dashes), once per process."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise SpecError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files its
    names lead to."""

    def __init__(self, root):
        self.root = Path(root)
        self.bench = self.root / BENCH
        self.data = load_json(self.root / "BENCHMARK.json")
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name):
        if name not in self.cells:
            raise SpecError(f"no cell {name!r} in BENCHMARK.json; cells: "
                            + ", ".join(sorted(self.cells)))
        return self.cells[name]

    def config(self, cell):
        entry = self.configs[cell["config"]]
        return load_json(self.root / entry["file"])

    def traffic(self, cell):
        return load_json(self.bench / "traffic" / f"{cell['traffic']}.json")

    def checks(self, cell):
        return load_json(self.bench / "checks" / f"{cell['name']}.json")

    def _in_cell(self, metric, cell):
        return cell["name"] in metric.get("workloads", self.cells)

    def end_to_end(self, cell):
        return [m for m in self.data["end_to_end"] if self._in_cell(m, cell)]

    def per_layer(self, cell):
        return [m for m in self.data["per_layer"] if self._in_cell(m, cell)]

    def metric(self, name):
        """The reader ``bench/metrics/<name>.py`` (any metric name: it may
        hold dots and dashes), imported under a name of its own."""
        path = self.bench / "metrics" / f"{name}.py"
        tag = hashlib.sha1(str(path).encode()).hexdigest()[:8]
        return load_module(path, f"bench_metric_{tag}")


def module(kind, name):
    """The module ``bench/<kind>/<name>.py`` (kind: layers,
    reference)."""
    if not name.isidentifier():
        raise SpecError(f"{kind} name {name!r} is not a module name")
    return importlib.import_module(f"{BENCH}.{kind}.{name}")
