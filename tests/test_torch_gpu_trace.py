"""The program's trace on the card: a traced call of the MoE and KV
wrappers fills every cycle bucket of its kernel's counters, each kernel
starts after its ``.launch`` span opens on the profiler's clock, and an
untraced call moves neither the counters nor the log.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_trace.py
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import telemetry
from repro_torch.kernels import kv_shuttle, moe_dispatch

BUCKETS = telemetry.KERNEL_BUCKETS


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    telemetry.reset()
    yield torch.device("cuda")
    telemetry.reset()


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).cuda()


def _moe_call():
    """ServingStep's shape, cut: 4 ranks x 256 routed rows, skewed, with
    the shared expert's second stream."""
    rng = np.random.default_rng(3)
    n, T, d, f = 4, 256, 512, 256
    x = _f32(rng, (n, T, d))
    w1, w2 = _f32(rng, (n, d, 2 * f), d ** -.5), _f32(rng, (n, f, d), f ** -.5)
    shared = (x, _f32(rng, (d, 2 * f), d ** -.5), _f32(rng, (f, d), f ** -.5))
    return "moe_kernel", moe_dispatch.STAT_ROLES, lambda: \
        moe_dispatch.moe_dispatch_combine(
            x, w1, w2, counts=[128, 64, 48, 16], shared=shared,
            pipelined=True)


def _kv_call():
    """KVTransfer's chained handoff, cut: 2048 rows of d 1024 into dk 512."""
    rng = np.random.default_rng(4)
    T, d, dk = 2048, 1024, 512
    x = torch.zeros((2, T, d), device="cuda")
    x[0] = _f32(rng, (T, d))
    wk, wv = _f32(rng, (d, dk), d ** -.5), _f32(rng, (d, dk), d ** -.5)
    return "kv_shuttle_kernel", kv_shuttle.STAT_ROLES, lambda: \
        kv_shuttle.kv_shuttle(x, wk, wv, chained=True)


CALLS = {"moe": _moe_call, "kv": _kv_call}


def _traced(call):
    call()                       # built and warm, untraced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return prof


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(CALLS))
def test_a_traced_call_fills_every_bucket(cuda_device, which):
    kernel, roles, call = CALLS[which]()
    _traced(call)
    got = telemetry.collect()
    for role in roles:
        ctas, cycles, wait, gemm = (got[f"{kernel}.{role}.{b}"]
                                    for b in BUCKETS)
        assert ctas >= 1 and cycles > 0, (role, got)
        assert wait + gemm <= cycles, (role, got)
        # every role but the KV decode CTA runs tile products
        assert (gemm > 0) is (role != "decode"), (role, got)
    assert sum(got[f"{kernel}.{r}.wait"] for r in roles) > 0, got
    assert sum(got[f"{kernel}.{r}.ctas"] for r in roles) \
        <= (moe_dispatch.grid_for(cuda_device, 4, True, False)[0]
            if which == "moe" else kv_shuttle.grid_for(cuda_device)[0])
    for bucket in ("wait", "gemm"):
        share = telemetry.cycle_share(kernel, bucket)
        assert 0 < share < 100, (bucket, share)


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(CALLS))
def test_the_kernel_starts_after_its_launch_span_opens(cuda_device, which):
    kernel, _, call = CALLS[which]()
    prof = _traced(call)
    prefix = {"moe": "moe_dispatch", "kv": "kv_shuttle"}[which]
    log = {name: (call_id, parent, t0, t1)
           for name, call_id, parent, t0, t1 in telemetry.spans()}
    assert set(log) == {f"{prefix}.{k}" for k in
                        ("call", "prepare", "alloc", "launch")}
    assert len({v[0] for v in log.values()}) == 1
    events = list(prof.profiler.kineto_results.events())
    runs = [e for e in events if kernel in e.name()
            and str(e.device_type()).split(".")[-1] != "CPU"]
    assert len(runs) == 1, [e.name() for e in runs]
    launch = log[f"{prefix}.launch"]
    assert runs[0].start_ns() > launch[2]
    # the profiler's own range of the span, on the same clock as the log
    ranges = [e for e in events if e.name() == f"{prefix}.launch"
              and str(e.device_type()).split(".")[-1] == "CPU"]
    assert ranges and abs(ranges[0].start_ns() - launch[2]) <= 50_000
    assert runs[0].start_ns() > ranges[0].start_ns()
    # the spans are host ranges only: no device-side copy of one
    assert not [e.name() for e in events if e.name() in log
                and str(e.device_type()).split(".")[-1] != "CPU"]


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(CALLS))
def test_untraced_calls_move_neither_counters_nor_log(cuda_device, which):
    kernel, _, call = CALLS[which]()
    _traced(call)
    before, spans = telemetry.collect(), telemetry.spans()
    assert any(v for v in before.values())
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    assert telemetry.collect() == before
    assert telemetry.spans() == spans
    telemetry.reset()
    call()
    torch.cuda.synchronize()
    assert telemetry.collect() == {} and telemetry.spans() == []


@pytest.mark.gpu
@pytest.mark.parametrize("which", list(CALLS))
def test_one_traced_launch_in_count_every_is_counted(cuda_device, which):
    kernel, roles, call = CALLS[which]()
    _traced(call)
    one = telemetry.collect()
    telemetry.reset()
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(telemetry.COUNT_EVERY + 1):
            call()
        torch.cuda.synchronize()
    runs = [e for e in prof.profiler.kineto_results.events()
            if kernel in e.name()
            and str(e.device_type()).split(".")[-1] != "CPU"]
    assert len(runs) == telemetry.COUNT_EVERY + 1
    got = telemetry.collect()     # the first and the last launch counted
    for role in roles:
        assert got[f"{kernel}.{role}.ctas"] == 2 * one[f"{kernel}.{role}.ctas"]
