"""Phase ``serve_kinds`` of ``chip_smoke.py`` at the reduced sizes on the
CPU: a file of its own, so that no recurrent test file runs long under
the tier-1 command's ``--dist loadfile`` (a file a worker)."""
import dataclasses
import os
import sys

from repro_torch.configs import get_arch


def test_chip_smoke_serve_kinds_on_the_cpu():
    """The smoke's serve_kinds phase at the reduced sizes on the CPU (the
    shuttle's plain version, so no launch is counted); the full configs
    are the published ones, uncut, at the shapes the phase names."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    assert chip_smoke.phase_serve_kinds(
        "cpu", chip_smoke.kind_configs(small=True)) == {}
    full = chip_smoke.kind_configs()
    assert [(c.name, s) for c, s in full] == [
        ("xlstm-350m", (4, 512, 32)), ("recurrentgemma-9b", (2, 2304, 16)),
        ("whisper-large-v3", (4, 64, 32))]
    assert all(dataclasses.asdict(c) == dataclasses.asdict(get_arch(c.name))
               for c, _ in full)
    rg = full[1][0]
    assert full[1][1][1] > rg.window == 2048
    assert 7.0e9 < rg.param_count() < 8.0e9
