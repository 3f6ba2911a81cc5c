"""The port's serving suite (``repro_torch.suites.serving``) against the
reference's checked-in ``BENCH_serving.json``, on the CPU.

With the reference's hardware context (``V5E``) the four modeled rows at
the full serving shape equal the checked-in ones (the comparison
``tests/test_multidevice.py`` makes of the reference's own suite), and the
suite's checks at its reduced configs pass: the cascade's three overlap
points at l3, the two-stream marks, the pallas engine's tokens equal to
the host body's, the shuttled handoff bit for bit, and serving through a
dropped rank. The port's ``write_rows`` writes the reference's
``benchmarks/common.py::write_rows`` file for the same rows.
"""
import os
import sys

import pytest
import torch

from repro_torch.core.hardware import V5E
from repro_torch.suites import common, serving
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def v5e(tmp_path_factory):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield serving.run("cpu", chip=V5E, out=tmp_path_factory.mktemp(
            "serving") / "BENCH_serving.json")
    finally:
        torch.set_num_threads(before)


def test_serving_rows_equal_checked_in(v5e):
    want = common.read_json(os.path.join(ROOT, "BENCH_serving.json"))
    assert common.diff(v5e["artifact"], want) == []
    assert v5e["artifact"] == want
    assert common.read_json(v5e["out"]) == want


def test_serving_suite_checks_at_the_reduced_configs(v5e):
    assert {k: lv for k, (lv, _) in v5e["cascade"].items()} == {
        "TokenWeave": 3, "FLUX": 3, "DeepEP (NVL)": 3}
    assert v5e["marks"] == serving.MARKS
    assert v5e["two_stream_err"] < 2e-3
    c = v5e["engine"]
    assert (c["serve.decode_steps"], c["serve.tokens_generated"],
            c["sched.finished"]) == (3, 12, 4)
    assert v5e["handoff_blocks"] >= 1
    assert "num_experts_padded=4 for a new width of 2" \
        in v5e["degrade_refused"]


def test_serving_rows_on_the_h100_model(tmp_path):
    """On the card's model the four rows keep their order and each is no
    slower than the host's; the suite's other checks pass as on ``V5E``."""
    got = serving.run("cpu", out=tmp_path / "rows.json")
    rows = got["artifact"]["rows"]
    assert [r["name"] for r in rows] == [f"serving_step/{n}"
                                         for n, _ in serving.ROWS]
    us = [r["us_per_call"] for r in rows]
    assert all(u <= us[0] for u in us)
    want = common.read_json(os.path.join(ROOT, "BENCH_serving.json"))["rows"]
    assert all(a < b["us_per_call"] for a, b in zip(us, want))


def test_write_rows_equals_the_references(tmp_path):
    sys.path.insert(0, ROOT)
    try:
        from benchmarks.common import write_rows as reference_write_rows
    finally:
        sys.path.remove(ROOT)
    rows = [("serving_step/a", 361.0200566903553, "tokens_per_s=2836408"),
            ("b", 1, 2.5), ("c/d", 0.1 + 0.2, "")]
    got = common.write_rows(tmp_path / "port.json", rows)
    want = reference_write_rows(tmp_path / "ref.json", rows)
    assert got == want
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "ref.json").read_bytes()
