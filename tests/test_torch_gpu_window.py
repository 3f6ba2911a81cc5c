"""The send window of the four cooperative Hopper kernels, on the card.

Each of moe_dispatch, kv_shuttle, gemm_allgather and ring_attention runs
at contexts 1, 2 and 4 at the main path's shapes (PERF.md §4: the serving
and skewed moe cells, KVTransfer's width and the engine's cache handoff,
GemmAllGather's and RingAttention's defaults) and at the shapes of a
dropped rank's survivors (n = 3: moe's respilled counts, gemm_allgather's
683 two-row COUNTER chunks, the ring's 683 two-row chunks a step), each
held to its plain version. The probe build (``-DCUCO_PROBE``) of each
kernel logs every CTA's window at the full grid, and each kernel's
``check_log`` holds the log to the contract: the depth profile of every
CTA equal to ``send_window_depths`` (so at contexts 2 and 4 a CTA with
that many rounds reaches that depth), drained at every drain point, its
rounds in the schedule's order, the rank's rounds all there, the receive
waits equal to ``completion_ticks``. gemm_allgather at one CTA a rank
passes the copied ``ScheduleProbe.check`` where its tile is the
schedule's round. A stress of 200 launches a kernel at contexts 4 holds
every output, for a race that shows only sometimes.

Marked ``gpu``: each test skips (inside a fixture) where there is no H100
and ``nvcc``. This file imports only torch and the port:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_window.py

Tolerances, max-abs-normalised: 1e-4 in f32 (sums in another order,
3xTF32 products), 1e-3 on moe's int8 wire (a tie may round the other
way); the bf16 ring each element within one bf16 step of its plain
version plus 1e-4; copies bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.trace import ScheduleProbe
from repro_torch.kernels import gemm_allgather as ga
from repro_torch.kernels import kv_shuttle as kv
from repro_torch.kernels import moe_dispatch as moe
from repro_torch.kernels import ring_attention as ra
from repro_torch.kernels.moe_dispatch import make_schedule
from repro_torch.core.schedule import make_broadcast_schedule
from repro_torch.kernels import window

CONTEXTS = [1, 2, 4]
STRESS = 200


@pytest.fixture
def cuda_device():
    from repro_torch import compat
    if not compat.has_hopper():
        pytest.skip("needs an H100 (compute capability 9.0) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).cuda()


def _err(got, want):
    """max |got - want| / max |want|, on the card."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


# ------------------------------------------------------------ moe_dispatch

MOE_CELLS = {   # n, T, d, f, fs (0: no second stream), counts
    "serving": (4, 256, 7168, 2048, 2048, [97, 80, 50, 29]),
    "skewed": (4, 256, 512, 1024, 0, [174, 57, 19, 6]),
    "moe_n3": (3, 256, 512, 1024, 0, [174, 19, 63]),
    "serving_n3": (3, 256, 7168, 2048, 2048, [107, 85, 64]),
}


@functools.lru_cache(maxsize=None)
def _moe_inputs(cell):
    n, T, d, f, fs, counts = MOE_CELLS[cell]
    rng = np.random.default_rng(len(cell))
    x = _f32(rng, (n, T, d))
    w1, w2 = _f32(rng, (n, d, 2 * f), d ** -.5), _f32(rng, (n, f, d),
                                                      f ** -.5)
    shared = None if not fs else (x, _f32(rng, (d, 2 * fs), d ** -.5),
                                  _f32(rng, (fs, d), fs ** -.5))
    return x, w1, w2, shared, counts


def _moe_want(cell, knobs):
    x, w1, w2, shared, counts = _moe_inputs(cell)
    return moe.moe_dispatch_combine_ref(x, w1, w2, counts=counts,
                                        shared=shared,
                                        wire_i8=knobs.get("wire_i8", False))


def _moe_close(got, want, knobs):
    tol = 1e-3 if knobs.get("wire_i8") else 1e-4
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert _err(g, w) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("variant", list(moe.VARIANTS))
@pytest.mark.parametrize("cell", list(MOE_CELLS))
def test_moe_at_every_contexts_matches_plain_version(cuda_device, cell,
                                                     variant, contexts):
    x, w1, w2, shared, counts = _moe_inputs(cell)
    knobs = moe.VARIANTS[variant]
    got = moe.moe_dispatch_combine(x, w1, w2, counts=counts, shared=shared,
                                   contexts=contexts, **knobs)
    _moe_close(got, _moe_want(cell, knobs), knobs)


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("variant", ["tile_fused", "deferred_signal"])
@pytest.mark.parametrize("cell", ["serving", "skewed", "moe_n3"])
def test_moe_probe_log_keeps_the_window(cuda_device, cell, variant,
                                        contexts):
    x, w1, w2, shared, counts = _moe_inputs(cell)
    knobs = moe.VARIANTS[variant]
    out, events, starts = moe.moe_dispatch_logged(
        x, w1, w2, counts=counts, shared=shared, contexts=contexts, **knobs)
    _moe_close(out, _moe_want(cell, knobs), knobs)
    got = moe.check_log(events, starts, make_schedule(counts), d=x.shape[2],
                        contexts=contexts, shared=shared is not None, **knobs)
    assert got["max_depth"] == contexts
    probe = ScheduleProbe()
    moe.moe_dispatch_combine(x, w1, w2, counts=counts, shared=shared,
                             contexts=contexts, probe=probe, **knobs)
    assert sorted(probe.marks) == sorted(
        ["dispatch_issued", "dispatch_drained"]
        + (["shared_ffn"] if shared is not None else []))


# ------------------------------------------------------------ kv_shuttle


@functools.lru_cache(maxsize=1)
def _kv_inputs(T=4096, d=4096, dk=512):
    rng = np.random.default_rng(7)
    x = torch.zeros((2, T, d), device="cuda")
    x[0] = _f32(rng, (T, d))
    return x, _f32(rng, (d, dk), d ** -.5), _f32(rng, (d, dk), d ** -.5)


@functools.lru_cache(maxsize=1)
def _cache_inputs(rows=558_080, width=64):
    rng = np.random.default_rng(8)
    kvs = torch.zeros((2, 2 * rows, width), dtype=torch.bfloat16,
                      device="cuda")
    kvs[0] = _f32(rng, (2 * rows, width)).bfloat16()
    return kvs


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("variant", list(kv.VARIANTS))
def test_kv_at_every_contexts_matches_plain_version(cuda_device, variant,
                                                    contexts):
    x, wk, wv = _kv_inputs()
    knobs = kv.VARIANTS[variant]
    got = kv.kv_shuttle(x, wk, wv, contexts=contexts, **knobs)
    want = kv.kv_shuttle_plain(x, wk, wv, **knobs)
    for g, w in zip(got, want):
        assert _err(g, w) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("variant", list(kv.PURE_VARIANTS))
def test_kv_handoff_at_every_contexts_is_bit_exact(cuda_device, variant,
                                                   contexts):
    kvs = _cache_inputs()
    rows = kvs.shape[1] // 2
    ko, vo = kv.kv_cache_shuttle(kvs, contexts=contexts,
                                 **kv.PURE_VARIANTS[variant])
    assert torch.equal(ko[1], kvs[0, :rows])
    assert torch.equal(vo[1], kvs[0, rows:])


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("variant", ["sequential", "fused_counter",
                                     "pure_chained"])
def test_kv_probe_log_keeps_the_window(cuda_device, variant, contexts):
    if variant.startswith("pure_"):
        kvs = _cache_inputs()
        ko, vo, events, meta = kv.kv_shuttle_logged(
            kvs, pure=True, contexts=contexts,
            **kv.PURE_VARIANTS[variant])
        assert torch.equal(ko[1], kvs[0, :kvs.shape[1] // 2])
    else:
        x, wk, wv = _kv_inputs()
        ko, vo, events, meta = kv.kv_shuttle_logged(
            x, wk, wv, contexts=contexts, **kv.VARIANTS[variant])
        assert _err(ko, kv.kv_shuttle_plain(x, wk, wv)[0]) < 1e-4
    got = kv.check_log(events, **meta)
    # sequential CTAs drain before their first V unit: a K unit and a V
    # unit of one CTA are never in flight together
    most = max(max(window.segments(evs)) for evs in events[:-1])
    assert got["max_depth"] == min(contexts, most)


# ------------------------------------------------------------ gemm_allgather

GA_SHAPES = {"defaults": (4, 1024, 4096, 4096), "n3": (3, 1366, 4096, 4096)}
GA_VARIANTS = dict(ga.VARIANTS, fused_counter_tm2=dict(fused=True,
                                                       counter=True,
                                                       tile_m=2))


@functools.lru_cache(maxsize=None)
def _ga_inputs(shape):
    n, M_l, K, N = GA_SHAPES[shape]
    rng = np.random.default_rng(M_l)
    return _f32(rng, (n, M_l, K)), _f32(rng, (K, N), K ** -.5)


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("variant", list(GA_VARIANTS))
@pytest.mark.parametrize("shape", list(GA_SHAPES))
def test_gemm_allgather_at_every_contexts_matches_plain_version(
        cuda_device, shape, variant, contexts):
    a, b = _ga_inputs(shape)
    got = ga.gemm_allgather(a, b, contexts=contexts, **GA_VARIANTS[variant])
    assert _err(got, ga.gemm_allgather_plain(a, b)) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("variant", ["deferred", "fused_counter",
                                     "fused_counter_tm2"])
@pytest.mark.parametrize("shape", list(GA_SHAPES))
def test_gemm_allgather_probe_log_keeps_the_window(cuda_device, shape,
                                                   variant, contexts):
    n, M_l, K, N = GA_SHAPES[shape]
    a, b = _ga_inputs(shape)
    knobs = GA_VARIANTS[variant]
    out, events = ga.gemm_allgather_logged(a, b, contexts=contexts, **knobs)
    assert _err(out, ga.gemm_allgather_plain(a, b)) < 1e-4
    got = ga.check_log(events, n=n, M_l=M_l, N=N, contexts=contexts, **knobs)
    assert got["max_depth"] == (min(contexts, n - 1) if not knobs["fused"]
                                else contexts)


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("fused,counter", [(True, True), (True, False),
                                           (False, False)])
def test_gemm_allgather_one_cta_a_rank_passes_schedule_probe_check(
        cuda_device, fused, counter, contexts):
    """At one CTA a rank the rank's program is one sequence; with N = 128
    and tile_m = 128 a card tile is the schedule's round, so the copied
    ``ScheduleProbe.check`` applies unchanged."""
    rng = np.random.default_rng(3)
    n, M_l, K, N = 4, 1024, 4096, 128
    a, b = _f32(rng, (n, M_l, K)), _f32(rng, (K, N), K ** -.5)
    probe = ScheduleProbe()
    out = ga.gemm_allgather(a, b, tile_m=128, fused=fused, counter=counter,
                            contexts=contexts, probe=probe)
    assert _err(out, ga.gemm_allgather_plain(a, b)) < 1e-4
    got = probe.check(make_broadcast_schedule(n, M_l, 128, fused), contexts,
                      counter)
    assert got["max_depth"] == min(contexts, len(
        make_broadcast_schedule(n, M_l, 128, fused).rounds))


# ------------------------------------------------------------ ring_attention

RING_SHAPES = {"defaults": (4, 8, 1024, 64), "n3": (3, 8, 1366, 64)}
RING_CASES = [("defaults", v) for v in ra.VARIANTS] + [
    ("n3", "fused_counter_kc2"), ("defaults", "fused_counter_bf16")]
RING_KNOBS = dict(ra.VARIANTS, fused_counter_kc2=dict(
    fused=True, counter=True, kv_chunk=2), **ra.BF16_VARIANTS)


@functools.lru_cache(maxsize=None)
def _ring_inputs(shape, bf16=False):
    rng = np.random.default_rng(sum(RING_SHAPES[shape]))
    qkv = [_f32(rng, RING_SHAPES[shape]) for _ in range(3)]
    return [t.bfloat16() for t in qkv] if bf16 else qkv


def _ring_close(got, want):
    if got.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                          - 7)
        assert bool(((g - w).abs() <= step + 1e-4).all())
    else:
        assert _err(got, want) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("shape,variant", RING_CASES)
def test_ring_at_every_contexts_matches_plain_version(cuda_device, shape,
                                                      variant, contexts):
    q, k, v = _ring_inputs(shape, variant.endswith("_bf16"))
    knobs = RING_KNOBS[variant]
    got = ra.ring_attention(q, k, v, contexts=contexts, **knobs)
    _ring_close(got, ra.ring_attention_plain(q, k, v, **knobs))


@pytest.mark.gpu
@pytest.mark.parametrize("contexts", CONTEXTS)
@pytest.mark.parametrize("shape,variant", [
    ("defaults", "fused_counter"), ("defaults", "fused_signal"),
    ("defaults", "pipelined"), ("n3", "fused_counter_kc2")])
def test_ring_probe_log_keeps_the_window(cuda_device, shape, variant,
                                         contexts):
    n, BH, Sl, hd = RING_SHAPES[shape]
    q, k, v = _ring_inputs(shape)
    knobs = RING_KNOBS[variant]
    out, events, cta0 = ra.ring_attention_logged(q, k, v, contexts=contexts,
                                                 **knobs)
    _ring_close(out, ra.ring_attention_plain(q, k, v, **knobs))
    got = ra.check_log(events, cta0, n=n, Sl=Sl, contexts=contexts, **knobs)
    assert got["max_depth"] == (contexts if knobs.get("fused") else 1)


# ------------------------------------------------------------ the stress


def _stress(run, check):
    for i in range(STRESS):
        out = run()
        if i % 10 == 9 or i == STRESS - 1:
            torch.cuda.synchronize()
        check(out)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["moe_dispatch", "kv_shuttle",
                                    "gemm_allgather", "ring_attention"])
def test_200_launches_at_contexts_4(cuda_device, kernel):
    if kernel == "moe_dispatch":
        x, w1, w2, shared, counts = _moe_inputs("serving")
        want = _moe_want("serving", moe.VARIANTS["tile_fused"])
        _stress(lambda: moe.moe_dispatch_combine(
            x, w1, w2, counts=counts, shared=shared, contexts=4,
            tile_fused=True), lambda o: _moe_close(o, want, {}))
    elif kernel == "kv_shuttle":
        x, wk, wv = _kv_inputs()
        want = kv.kv_shuttle_plain(x, wk, wv)
        _stress(lambda: kv.kv_shuttle(x, wk, wv, contexts=4, fused=True,
                                      counter=True, kv_chunk=64),
                lambda o: [_err(g, w) < 1e-4 or pytest.fail("kv differs")
                           for g, w in zip(o, want)])
    elif kernel == "gemm_allgather":
        a, b = _ga_inputs("defaults")
        want = ga.gemm_allgather_plain(a, b)
        _stress(lambda: ga.gemm_allgather(a, b, contexts=4, fused=True,
                                          counter=True),
                lambda o: _err(o, want) < 1e-4 or pytest.fail("ga differs"))
    else:
        q, k, v = _ring_inputs("defaults")
        knobs = ra.VARIANTS["fused_counter"]
        want = ra.ring_attention_plain(q, k, v, **knobs)
        _stress(lambda: ra.ring_attention(q, k, v, contexts=4, **knobs),
                lambda o: _ring_close(o, want))
