"""Phase ``attn_kernels`` of ``chip_smoke.py`` at a tiny size on the CPU,
where the wrappers compute the plain versions (every error 0, no launch
counted): one half of ``test_chip_smoke_attention_phases_on_the_cpu``,
whose other half (``ring_main``) is
``tests/test_torch_attention_ring_phase.py``: the two run long enough
to take a file each (the tier-1 command gives a worker a file)."""
import os
import sys

import pytest

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ring_attention as ra

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


@pytest.mark.parametrize("phase", ["attn_kernels"])
def test_chip_smoke_attention_phases_on_the_cpu(phase):
    recs = chip_smoke.phase_attn_kernels(
        "cpu", chip_smoke.ring_workload(small=True), iters=1)
    assert [r["name"] for r in recs] == \
        [f"flash_attention/{k}" for k in fa.VARIANTS] \
        + [f"ring_attention/{k}" for k in ra.VARIANTS] \
        + [f"ring_attention/{k}" for k in ra.BF16_VARIANTS]
    check_records(recs)
