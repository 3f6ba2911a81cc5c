"""Each plain reference against the port's CPU plain path at a tiny size
(the test imports both; the reference imports nothing of the port), and
the control's precision against the reference's."""
import numpy as np
import pytest
import torch

from bench.layers import kv_cache as cache_layer
from bench.reference import common, kv as kv_ref, kv_cache as cache_ref
from bench.reference import moe as moe_ref


def _moe_inputs(n, T, d, f, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, T, d), generator=g)
    w1 = torch.randn((n, d, 2 * f), generator=g) / d ** 0.5
    w2 = torch.randn((n, f, d), generator=g) / f ** 0.5
    s1 = torch.randn((d, 2 * f), generator=g) / d ** 0.5
    s2 = torch.randn((f, d), generator=g) / f ** 0.5
    return x, w1, w2, (s1, s2)


def _assemble(blocks, x):
    y = torch.zeros_like(x)
    for off, c, b in blocks:
        y[:, off:off + c] = b
    return y


@pytest.mark.parametrize("n,T,skew", [(4, 96, 2.0), (4, 4096, 5.0),
                                      (2, 6144, 3.0), (4, 256, 1.0),
                                      (8, 100, 4.0)])
def test_skew_law_is_the_ports(n, T, skew):
    from repro_torch.workloads import get_workload
    w = get_workload("moe_dispatch", n_dev=n, tokens_per_rank=T, skew=skew)
    assert moe_ref.skew_counts(n, T, skew) == [int(c) for c in w._counts(T)]


@pytest.mark.parametrize("wire_i8", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_reference_matches_the_ports_plain_path(wire_i8, shared):
    from repro_torch.kernels.moe_dispatch import moe_dispatch_combine
    n, T, d, f = 4, 48, 64, 64
    x, w1, w2, s = _moe_inputs(n, T, d, f, seed=3)
    counts = moe_ref.skew_counts(n, T, 3.0)
    got = moe_dispatch_combine(
        x, w1, w2, counts=counts, wire_i8=wire_i8,
        shared=(x, *s) if shared else None)
    if shared:
        got = got[0] + got[1]
    want = _assemble(moe_ref.blocks(x, w1, w2, counts, wire_i8=wire_i8,
                                    shared=s if shared else None), x)
    assert common.row_rel_err(got, want) < 1e-6


def test_kv_reference_matches_the_ports_plain_path():
    from repro_torch.kernels.kv_shuttle import kv_shuttle
    g = torch.Generator().manual_seed(5)
    x = torch.zeros((2, 77, 64))
    x[0] = torch.randn((77, 64), generator=g)
    wk, wv = (torch.randn((64, 32), generator=g) for _ in range(2))
    k, v = kv_shuttle(x, wk, wv, chained=True)
    want_k, want_v = kv_ref.handoff(x[0], wk, wv)
    assert common.row_rel_err(k[1], want_k) < 1e-6
    assert common.row_rel_err(v[1], want_v) < 1e-6
    assert not k[0].any() and not v[0].any()


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -3.0 - 2**-12])
    assert common.tf32_round(t).tolist() == [1.0, 1.0 + 2**-10,
                                             1.0 + 2**-10, 1.0, -3.0]
    r = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    rel = ((common.tf32_round(r) - r).abs() / r.abs()).max()
    assert 2**-12 < rel <= 2**-11


def test_control_reads_far_above_the_float32_reference():
    n, T, d, f = 4, 64, 256, 128
    x, w1, w2, s = _moe_inputs(n, T, d, f, seed=9)
    counts = moe_ref.skew_counts(n, T, 2.0)
    want = _assemble(moe_ref.blocks(x, w1, w2, counts), x)
    ctrl = _assemble(moe_ref.blocks(x, w1, w2, counts, mode="tf32"), x)
    again = _assemble(moe_ref.blocks(x.double().float(), w1, w2, counts), x)
    assert common.row_rel_err(again, want) == 0.0
    assert common.row_rel_err(ctrl, want) > 1e-4
    assert np.isinf(common.row_rel_err(torch.full_like(want, np.nan), want))


TINY_MISTRAL = {"model_type": "mistral", "hidden_size": 64,
                "num_attention_heads": 4, "num_key_value_heads": 2,
                "num_hidden_layers": 3, "intermediate_size": 128,
                "vocab_size": 256, "rope_theta": 1e6,
                "torch_dtype": "bfloat16"}


def test_kv_cache_layout_is_engine_prefills():
    """The layer makes each request's cache in the blocks, leaves, shapes
    and types that ``Engine.prefill`` of the same backbone returns for a
    prompt of T tokens prefilled into T slots."""
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    T = 11
    cfg = cache_layer.model_config(TINY_MISTRAL)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = Engine(cfg, params, ServeConfig(max_seq=T))
    _, cache, _ = eng.prefill({"tokens": torch.zeros((1, T),
                                                     dtype=torch.long)})
    layer = cache_layer.Layer(TINY_MISTRAL, {}, [{"prompt_tokens": T}], 5,
                              "cpu")
    made = layer._cache(0)

    def form(c):
        return {n: {k: (tuple(t.shape), t.dtype) for k, t in b.items()}
                for n, b in c.items()}
    assert form(made) == form(cache)
    assert torch.equal(made["s0"]["kpos"], cache["s0"]["kpos"])


def test_kv_cache_reference_matches_the_engines_plain_handoff():
    layer = cache_layer.Layer(TINY_MISTRAL, {}, [{"prompt_tokens": 9},
                                                 {"prompt_tokens": 30}],
                              2**31 + 1, "cpu")
    for j, step in enumerate(layer.steps):
        got = step()
        want = cache_ref.handoff(layer._cache(j))
        assert set(got) == set(want) == {"s0"}
        for leaf, w in want["s0"].items():
            assert torch.equal(got["s0"][leaf], w), leaf
        assert layer.check(j, got) == {"row_rel_err": 0.0}
    # the control: a bfloat16 cache rounded through float8 e4m3
    ctrl = cache_ref.handoff(layer._cache(1), torch.float8_e4m3fn)
    err = common.row_rel_err(ctrl["s0"]["k"], layer._cache(1)["s0"]["k"])
    assert 1e-2 < err < 0.2
    assert torch.equal(ctrl["s0"]["kpos"], layer._cache(1)["s0"]["kpos"])
