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

# each layer kind's widths cut to a size the CPU runs in a blink
TINY_CONFIG = {"moe": dict(hidden_size=64, moe_intermediate_size=64),
               "kv": dict(hidden_size=64, num_attention_heads=4,
                          num_key_value_heads=2)}
TINY_PARAMS = {"tokens_per_rank": {"fixed": 32},
               "prompt_tokens": {"lognormal_quantiles": {
                   "median": 40, "sigma": 0.6, "min": 8, "max": 160}}}


def shrunk_copy(dest, config, params):
    """``BENCHMARK.json`` and ``bench/`` copied to ``dest``, every
    configuration's widths and every mix's sizes cut as given."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (dest / "bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(config[cfg["layer"]])
        path.write_text(json.dumps(cfg))
    for path in (dest / "bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        for k in mix["params"]:
            if k in params:
                mix["params"][k] = params[k]
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``bench/`` at the tiny size."""
    return shrunk_copy(tmp_path, TINY_CONFIG, TINY_PARAMS)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (sm_90)")
    return torch.device("cuda:0")
