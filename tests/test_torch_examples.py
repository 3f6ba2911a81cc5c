"""The port's examples (``python -m repro_torch.examples.<name>``) and its
schedule lint (``python -m repro_torch.tools.schedule_lint``), on the CPU.

Each example's ``main`` runs at its smallest arguments with ``--device
cpu`` (the kernels' plain versions). The lint's rows (workload, design
point, verdict and its detail: the ops verified or the violations) over
the whole grid, its mutation corpus rows and its checker catalog must
equal the reference's ``tools/schedule_lint.py``'s, with the same exit
code; only the elapsed times differ. The whole grid takes a few seconds
in each package, so no subset is taken.
"""
import importlib.util
import json
import os

import pytest
import torch

from repro_torch.examples import (codesign_search, quickstart, serve_decode,
                                  train_moe_100m)
from repro_torch.tools import schedule_lint
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CPU = ["--device", "cpu"]


def test_quickstart_trains_and_generates():
    losses, toks = quickstart.main(["--steps", "3"] + CPU)
    assert len(losses) == 3 and all(map(lambda v: v == v, losses))
    assert toks.shape == (2, 8) and toks.device.type == "cpu"


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-large-v3"])
def test_serve_decode_disaggregated_equals_monolithic(arch):
    mono, disagg = serve_decode.main(["--arch", arch, "--batch", "2",
                                      "--prompt-len", "8", "--new-tokens",
                                      "4"] + CPU)
    assert mono.shape == (2, 4)
    assert torch.equal(mono, disagg)


@pytest.mark.parametrize("workload", ["moe_dispatch", "kv_transfer",
                                      "gemm_allgather", "ring_attention"])
def test_codesign_search_reaches_a_verified_best(workload):
    res = codesign_search.main(["--workload", workload, "--generations",
                                "1", "--islands", "1"] + CPU)
    assert res.best.score >= res.seed_score > 0
    assert res.best.result.level == 3


def test_train_moe_100m_trains_and_resumes(tmp_path):
    """A step on the (4, 2) mesh with a checkpoint at the last, then a run
    to step 2 resumes from it."""
    argv = ["--batch", "4", "--seq", "16", "--ckpt", str(tmp_path)] + CPU
    losses, last = train_moe_100m.main(["--steps", "1"] + argv)
    assert last == 1 and len(losses) == 1
    more, last = train_moe_100m.main(["--steps", "2"] + argv)
    assert last == 2 and len(more) == 1
    cfg = train_moe_100m.config()
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts,
            cfg.experts_per_token, cfg.vocab_size) == (8, 512, 8, 2, 32000)


def test_examples_refuse_no_device_fallback():
    """``--device cuda`` on a machine with no card raises; nothing falls
    back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        serve_decode.main(["--batch", "1", "--prompt-len", "4",
                           "--new-tokens", "1"])


def _reference_lint():
    spec = importlib.util.spec_from_file_location(
        "reference_schedule_lint", os.path.join(ROOT, "tools",
                                                "schedule_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "elapsed_ms"} for r in rows]


# the port's workloads that the reference package does not have: LongCat's
# ScMoE double-layer (workloads/scmoe.py)
OWN_WORKLOADS = {"scmoe_step"}


def _theirs(rows):
    return [r for r in rows if r["workload"] not in OWN_WORKLOADS]


def test_schedule_lint_equals_reference(tmp_path, capsys):
    ref = _reference_lint()
    paths = {}
    for name, mod in (("port", schedule_lint), ("ref", ref)):
        paths[name] = tmp_path / f"{name}.json"
        assert mod.main(["--mutations", "--quiet", "--json",
                         str(paths[name])]) == 0
    got, want = (json.loads(paths[k].read_text()) for k in ("port", "ref"))
    assert got["schema"] == want["schema"] == "schedule-lint/v1"
    assert _strip(_theirs(got["points"])) == _strip(want["points"])
    assert _strip(got["mutations"]) == _strip(want["mutations"])
    assert sum(r["status"] == "ok" for r in got["points"]) > 0
    assert all(r["caught"] for r in got["mutations"])
    capsys.readouterr()
    catalogs = []
    for mod in (schedule_lint, ref):
        assert mod.main(["--catalog"]) == 0
        catalogs.append(capsys.readouterr().out)
    assert catalogs[0] == catalogs[1] and catalogs[0].count("\n") > 5


def test_schedule_lint_holds_the_ports_own_workloads_clean():
    """The ScMoE step's lines: every expert-system point verified on the
    kernel's schedule at the router's mean (the kernel points) or
    vacuous (the XLA points), none failing."""
    rows, failures = schedule_lint.lint_points(quiet=True)
    own = [r for r in rows if r["workload"] in OWN_WORKLOADS]
    assert not failures
    assert {r["workload"] for r in own} == OWN_WORKLOADS
    status = {r["point"]: r["status"] for r in own}
    assert status == {"CONSERVATIVE": "vacuous", "TokenWeave": "vacuous",
                      "DeepEP (IB)": "ok", "DeepEP (NVL)": "ok",
                      "FLUX": "ok"}
    assert all(r["detail"].endswith(" ops") for r in own
               if r["status"] == "ok")
