"""Phase ``window`` of ``chip_smoke.py`` at a tiny size on the CPU, where
the wrappers compute the plain versions: every cooperative variant at
contexts 1, 2 and 4, one time each, no launch counted. The phase runs
long on the CPU, so ``test_chip_smoke_window_phase_on_the_cpu`` takes it
in two parts, a file each (the tier-1 command gives a worker a file):
here moe_dispatch, kv_shuttle, gemm_allgather and the ring's f32
variants at its defaults; ``tests/test_torch_window_ring_phase.py`` the
ring's other cases."""
import os
import sys

import pytest

from repro_torch.kernels import gemm_allgather as ga
from repro_torch.kernels import kv_shuttle as kv
from repro_torch.kernels import moe_dispatch as moe
from repro_torch.kernels import ring_attention as ra

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

KERNELS = (moe, kv, ga, ra)


def ring_defaults(kernel, shape):
    """The cases of the first part: every kernel's but the ring's, and the
    ring's f32 variants at RingAttention's defaults."""
    return kernel != "ring_attention" or shape.startswith("defaults n=")


def only(monkeypatch, keep):
    """Phase ``window`` over the cases ``keep(kernel, shape)`` holds for."""
    cases = chip_smoke._window_cases
    monkeypatch.setattr(chip_smoke, "_window_cases", lambda device, small=(
        False): (c for c in cases(device, small) if keep(c[0], c[2])))


@pytest.mark.parametrize("part", ["all_but_the_ring_s_other_cases"])
def test_chip_smoke_window_phase_on_the_cpu(part, monkeypatch):
    only(monkeypatch, ring_defaults)
    times = chip_smoke.phase_window("cpu", iters=1, small=True)
    assert {k[0] for k in times} == {"moe_dispatch", "kv_shuttle",
                                     "gemm_allgather", "ring_attention"}
    assert {k[1] for k in times} >= set(moe.VARIANTS) | set(kv.VARIANTS) \
        | set(ga.VARIANTS) | set(ra.VARIANTS)
    assert all(sorted(row) == [1, 2, 4] for row in times.values())
    for kern in KERNELS:
        assert kern.launches() == 0 and not kern.CONTEXTS_LAUNCHED
