"""Phase ``ring_main`` of ``chip_smoke.py`` at a tiny size on the CPU,
where the wrappers compute the plain versions (every error 0, no launch
counted): one half of ``test_chip_smoke_attention_phases_on_the_cpu``
(the other, ``attn_kernels``, is
``tests/test_torch_attention_kernels_phase.py``). ``ring_main`` also runs
its checks of the public wrappers against each other and the oracle,
and gives the records of fig3's row from its counted run's outputs."""
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def check_records(recs):
    for rec in recs:
        assert KEYS <= set(rec) and rec["max_abs_err"] == 0.0
        assert rec["_path"] == "ring_main"
        assert os.path.exists(os.path.join(ROOT, rec["source"]))
        assert rec["replaces"] in ("src/repro/kernels/flash_attention.py:72",
                                   "src/repro/kernels/ring_attention.py:197")


@pytest.mark.parametrize("phase", ["ring_main"])
def test_chip_smoke_attention_phases_on_the_cpu(phase):
    counts, deployed = chip_smoke.phase_ring_main(
        "cpu", chip_smoke.ring_workload(small=True),
        chip_smoke.deploy_shape(small=True), iters=1)
    assert counts == {}
    assert [r["name"] for r in deployed] == \
        ["ring_attention/pipelined", "ring_attention/fused_counter"]
    BH, seq = chip_smoke.deploy_shape(small=True)
    assert [r["_key"][3] for r in deployed] == [BH, BH]
    check_records(deployed)
