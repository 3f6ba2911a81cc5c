"""Set-up of the benchmark's own tests: the checkout's root, ``src`` and
this folder on ``sys.path``, a tiny copy of the benchmark to drive runs
on the CPU, and the card fixture of the tests marked ``gpu``.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT, Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import plant  # noqa: E402


def shrunk_copy(dest, root=ROOT):
    """``BENCHMARK.json`` and ``bench/`` of the checkout at ``root`` copied
    to ``dest`` (the tests' hooks too, under ``bench/tests/kinds/``), each
    configuration's widths and each mix's sizes cut to a size the CPU
    runs in a blink by the hooks of its cells' layer kind
    (``plant.hooks``)."""
    shutil.copy(root / "BENCHMARK.json", dest)
    shutil.copytree(root / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*",
                                                  "conftest.py", "plant.py"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    layers = {}
    for entry in bench["configs"]:
        path = dest / entry["file"]
        cfg = json.loads(path.read_text())
        cfg.update(plant.hooks(cfg["layer"], dest).CONFIG)
        path.write_text(json.dumps(cfg))
        layers[entry["name"]] = cfg["layer"]
    for cell in bench["workloads"]:
        path = dest / "bench" / "traffic" / f"{cell['traffic']}.json"
        mix = json.loads(path.read_text())
        params = plant.hooks(layers[cell["config"]], dest).PARAMS
        mix["params"].update({k: v for k, v in params.items()
                              if k in mix["params"]})
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``bench/`` at the tiny size."""
    return shrunk_copy(tmp_path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (sm_90)")
    return torch.device("cuda:0")
