"""``kernels/build.py``'s optional builds: the counting build of a kernel
compiles beside its production build, and its failure fails neither the
production build nor a preload; a later call that wants it raises the
compiler's output without another ``nvcc``. A stand-in compiler plays
``nvcc`` here, so this runs on the CPU."""
import sys

import pytest

from repro_torch import compat
from repro_torch.kernels import build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({calls!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if "-DCUCO_STATS" in args:
    print("cta_stats.cuh(1): error: planted")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").write("library")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(compat, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(compat, "build_dir", lambda: tmp_path / "build")
    for table in ("_LOADED", "_LOGS", "_FAILED", "_PRELOADED"):
        monkeypatch.setattr(build, table, {} if table != "_PRELOADED"
                            else set())
    return lambda: calls.read_text().splitlines() if calls.exists() else []


def test_a_failed_optional_build_fails_neither_build_nor_preload(fake_nvcc):
    prod, stats = ("kv_shuttle", ()), ("kv_shuttle", build.STATS_DEFINES)
    build.build_jobs([prod], [stats])
    assert len(fake_nvcc()) == 2          # both compiled together
    assert build._library(*prod)[1].exists()
    assert not build._library(*stats)[1].exists()
    with pytest.raises(build.KernelBuildError, match="planted"):
        build.build_jobs([stats])
    build.preload("kv_shuttle", lambda: build.load(*stats), "cpu", 0)
    build.preload("kv_shuttle", lambda: build.load(*stats), "cpu", 0)
    assert len(fake_nvcc()) == 2          # never compiled again
    build.build_jobs([prod], [stats])     # nothing left to build
    assert len(fake_nvcc()) == 2


def test_a_failed_required_build_still_raises(fake_nvcc):
    with pytest.raises(build.KernelBuildError, match="planted"):
        build.build_jobs([("moe_dispatch", build.STATS_DEFINES)],
                         [("moe_dispatch", ())])
    assert build._library("moe_dispatch")[1].exists()
