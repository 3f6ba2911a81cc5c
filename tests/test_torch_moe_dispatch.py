"""The moe_dispatch slice of the port against the JAX reference.

Every input is made with numpy from a seed and handed to both packages.
On the CPU the kernel wrapper computes its plain version,
``moe_dispatch_combine_ref``; these tests hold that plain version and the
port's workload builds against ``MoEDispatch.reference`` /
``ServingStep.reference``, ``quant_i8`` and ``swiglu_ffn`` of the
reference package (the reference's Pallas kernel itself does not trace on
this JAX version). ``tests/test_torch_gpu.py`` holds the CUDA kernel
against the plain version on the card.

Tolerances (max-abs-normalised error unless stated): 1e-5 between the
plain f32 versions (the same f32 arithmetic, summed in another order by
another BLAS); 8e-2 for outputs of the int8 wire (the cascade's int8
tolerance); int8 payloads equal on >= 99.9% of entries (an f32 division
may land a tie on the other side).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.compat import make_mesh
from repro.kernels.moe_dispatch import quant_i8 as jquant_i8
from repro.kernels.moe_dispatch import swiglu_ffn as jswiglu
from repro.workloads.moe_dispatch import MoEDispatch as JMoE
from repro.workloads.serving import ServingStep as JServing
from repro_torch.core import comm_graph
from repro_torch.core.design_space import CONSERVATIVE, EXPERT_SYSTEMS
from repro_torch.dist.mesh import VirtualMesh, record
from repro_torch.kernels import moe_dispatch as kern
from repro_torch.workloads.moe_dispatch import MoEDispatch as TMoE
from repro_torch.workloads.moe_dispatch import inputs_from_numpy
from repro_torch.workloads.serving import ServingStep as TServing
from torch_port_helpers import numpy_inputs, rel_err

RTOL = 1e-5
I8_TOL = 8e-2


def to_jax(arrs):
    return [jnp.asarray(a) for a in arrs]


# ---------------------------------------------------------- building blocks


def test_quant_i8_matches_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 96)) * rng.uniform(0.1, 10, (64, 1))
         ).astype(np.float32)
    x[5] = 0.0                                   # a zero padding row
    jq, js = jquant_i8(jnp.asarray(x))
    tq, ts = kern.quant_i8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.mean(np.asarray(jq) == tq.numpy()) >= 0.999
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_swiglu_matches_reference():
    x, w1, w2 = numpy_inputs(1, 32, 64, 48)
    want = jswiglu(jnp.asarray(x[0]), jnp.asarray(w1[0]), jnp.asarray(w2[0]))
    got = kern.swiglu_ffn(*[torch.from_numpy(a[0]) for a in (x, w1, w2)])
    assert rel_err(got, want) <= RTOL


# ------------------------------------------------------------ plain version


@pytest.mark.parametrize("skew,B,tight", [(3.0, 64, True), (3.0, 16, False),
                                          (5.0, 32, True), (1.0, 64, True)])
def test_plain_version_matches_moe_reference(skew, B, tight):
    n, T, d, f = 4, 256, 64, 96
    arrs = numpy_inputs(n, T, d, f, seed=int(skew))
    jw = JMoE(n_dev=n, tokens_per_rank=T, d=d, f=f, skew=skew)
    want = jw.reference(*to_jax(arrs))
    x, w1, w2 = inputs_from_numpy(*arrs, device="cpu")
    got = kern.moe_dispatch_combine_ref(x, w1, w2, counts=jw._counts(T),
                                        block_tokens=B, tight=tight)
    assert rel_err(got, want) <= RTOL
    # the port's own oracle is the same function
    tw = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f, skew=skew)
    assert rel_err(tw.reference(x, w1, w2), want) <= RTOL


def test_plain_version_two_stream_matches_serving_reference():
    n, T, d, f, fs = 4, 64, 64, 64, 128
    arrs = numpy_inputs(n, T, d, f, fs, seed=7)
    jw = JServing(n_dev=n, tokens_per_rank=T, d=d, f=f, f_shared=fs)
    want = jw.reference(*to_jax(arrs))
    x, w1, w2, s1, s2 = inputs_from_numpy(*arrs, device="cpu")
    y, ys = kern.moe_dispatch_combine_ref(
        x, w1, w2, counts=jw._counts(T), shared=(x, s1, s2))
    assert rel_err(y + ys, want) <= RTOL
    tw = TServing(n_dev=n, tokens_per_rank=T, d=d, f=f, f_shared=fs)
    assert rel_err(tw.reference(x, w1, w2, s1, s2), want) <= RTOL


def test_int8_wire_matches_reference_quantization():
    """The plain version's int8 wire equals the reference's quant_i8 ->
    dequant -> swiglu_ffn on the same staged rows."""
    n, T, d, f = 4, 256, 64, 96
    arrs = numpy_inputs(n, T, d, f, seed=11)
    jw = JMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)
    counts = [int(c) for c in jw._counts(T)]
    x, w1, w2 = inputs_from_numpy(*arrs, device="cpu")
    got = kern.moe_dispatch_combine_ref(x, w1, w2, counts=counts,
                                        wire_i8=True)
    off = 0
    for e, c in enumerate(counts):
        rows = arrs[0][:, off:off + c]           # rank r's rows for expert e
        jq, js = jquant_i8(jnp.asarray(rows))
        tq, _ = kern.quant_i8(torch.from_numpy(rows))
        assert np.mean(np.asarray(jq) == tq.numpy()) >= 0.999
        want = jswiglu(jq.astype(jnp.float32) * js, jnp.asarray(arrs[1][e]),
                       jnp.asarray(arrs[2][e]))
        assert rel_err(got[:, off:off + c], want) <= RTOL
        off += c
    exact = jw.reference(*to_jax(arrs))
    assert rel_err(got, exact) <= I8_TOL


def test_wrapper_runs_plain_version_on_cpu_tensors():
    n, T, d, f = 4, 256, 64, 64
    arrs = numpy_inputs(n, T, d, f)
    x, w1, w2 = inputs_from_numpy(*arrs, device="cpu")
    counts = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)._counts(T)
    kern.reset_launches()
    got = kern.moe_dispatch_combine(x, w1, w2, counts=counts,
                                    tile_fused=True, combine_tile=16)
    want = kern.moe_dispatch_combine_ref(x, w1, w2, counts=counts)
    assert torch.equal(got, want)
    assert kern.launches() == 0                  # no kernel ran
    with pytest.raises(ValueError, match="excludes a BARRIER"):
        kern.moe_dispatch_combine(x, w1, w2, counts=counts, barrier=True,
                                  tile_fused=True)
    with pytest.raises(ValueError, match="do not route"):
        kern.moe_dispatch_combine_ref(x, w1, w2, counts=[1, 2, 3, 4])
    with pytest.raises(ValueError, match="cuda or cpu"):
        kern.moe_dispatch_combine(x.to("meta"), w1.to("meta"),
                                  w2.to("meta"), counts=counts)


def test_variant_names():
    kw = dict(combine_tile=None, block_tokens=64)
    assert kern.variant_name(barrier=True, pipelined=False, tile_fused=False,
                             wire_i8=False, shared=True, **kw) \
        == "barrier+shared"
    assert kern.variant_name(barrier=False, pipelined=False, tile_fused=False,
                             wire_i8=False, shared=False, **kw) \
        == "deferred_signal"
    assert kern.variant_name(barrier=False, pipelined=True, tile_fused=True,
                             wire_i8=True, shared=False, combine_tile=16,
                             block_tokens=64) == "tile_fused_ct16+int8"


# ------------------------------------------------------- workload builders

DIRECTIVES = {
    "host": CONSERVATIVE,
    "host_i8": CONSERVATIVE.with_tunable("wire_i8", 1),
    "tokenweave": EXPERT_SYSTEMS["TokenWeave"],
    "tokenweave_i8": EXPERT_SYSTEMS["TokenWeave"].with_tunable("wire_i8", 1),
    "deepep_nvl": EXPERT_SYSTEMS["DeepEP (NVL)"],
    "flux_i8": EXPERT_SYSTEMS["FLUX"].with_tunable("wire_i8", 1),
}


@pytest.mark.parametrize("name", list(DIRECTIVES))
@pytest.mark.parametrize("serving", [False, True])
def test_port_builds_match_reference_oracle(name, serving):
    """Every port build, at n=4 on the virtual mesh, against the
    reference's oracle on the same inputs."""
    n, T, d, f, fs = 4, 256, 64, 64, 64
    if serving:
        arrs = numpy_inputs(n, T, d, f, fs, seed=5)
        jw = JServing(n_dev=n, tokens_per_rank=T, d=d, f=f, f_shared=fs,
                      skew=2.0)
        tw = TServing(n_dev=n, tokens_per_rank=T, d=d, f=f, f_shared=fs,
                      skew=2.0)
    else:
        arrs = numpy_inputs(n, T, d, f, seed=5)
        jw = JMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)
        tw = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)
    want = jw.reference(*to_jax(arrs))
    mesh = VirtualMesh(n, device="cpu")
    d_ = DIRECTIVES[name]
    got = tw.build(d_, mesh)(*inputs_from_numpy(*arrs, device="cpu"))
    tol = I8_TOL if d_.tunable("wire_i8", 0) else RTOL
    assert rel_err(got, want) <= tol


@pytest.mark.parametrize("overlap,wire_i8", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_host_builds_match_reference_xla_builds_at_one_rank(overlap, wire_i8):
    """The reference's XLA builds run here at n=1: the port's torch
    builds give the same numbers on the same inputs."""
    n, T, d, f = 1, 64, 64, 64
    arrs = numpy_inputs(n, T, d, f, seed=9)
    jw = JMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)
    tw = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)
    want = jw._make(make_mesh((1,), ("x",)), overlap=overlap,
                    wire_i8=wire_i8)(*to_jax(arrs))
    got = tw._make(VirtualMesh(1, device="cpu"), overlap=overlap,
                   wire_i8=wire_i8)(*inputs_from_numpy(*arrs, device="cpu"))
    assert rel_err(got, want) <= RTOL


def test_mesh_all_to_all_and_recorder():
    mesh = VirtualMesh(3, device="cpu")
    t = torch.arange(3 * 3 * 2, dtype=torch.float32).reshape(3, 3, 2)
    with record() as events:
        out = mesh.all_to_all(t)
    for r in range(3):
        for e in range(3):
            assert torch.equal(out[e, r], t[r, e])
    assert [ev.kind for ev in events] == ["all-to-all"]
    assert events[0].payload_bytes == 3 * 2 * 4
    with pytest.raises(ValueError):
        mesh.all_to_all(torch.zeros(2, 3, 1))


def test_comm_graph_matches_reference_at_one_rank():
    """The recorder-built graph of the host baseline has the reference
    jaxpr walk's collectives and payload bytes."""
    from repro.core import comm_graph as jcg
    n, T, d, f = 1, 64, 64, 64
    arrs = numpy_inputs(n, T, d, f)
    jw = JMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)
    tw = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)
    jg = jcg.analyze(jw.host_baseline(make_mesh((1,), ("x",))),
                     *to_jax(arrs))
    tg = comm_graph.analyze(tw.host_baseline(VirtualMesh(1, device="cpu")),
                            *inputs_from_numpy(*arrs, device="cpu"))
    assert [nd.kind for nd in tg.nodes] == [nd.kind for nd in jg.nodes]
    assert tg.collective_bytes == jg.collective_bytes
    assert [p[0] for p in tg.phases()] == [p[0] for p in jg.phases()]
    assert tg.nodes[1].producers and tg.nodes[0].consumers
    assert "all-to-all" in tg.describe()


@pytest.mark.parametrize("shape", [(4, 32, 32, 64, 0), (4, 96, 100, 72, 40),
                                   (2, 64, 64, 64, 48), (2, 64, 64, 64, 64)])
@pytest.mark.parametrize("wire_i8", [False, True])
def test_padding_to_the_tile_keeps_the_function(shape, wire_i8):
    """``pad_to_tiles`` (what the card's entry does where d, f or fs is not
    a multiple of the tile GEMM's 64): the plain version on the padded
    operands, cut back to d columns, is the plain version on the operands
    as given, and every padded column is zero."""
    n, T, d, f, fs = shape
    ts = inputs_from_numpy(*numpy_inputs(n, T, d, f, fs, seed=d + f),
                           device="cpu")
    shared = (ts[0], ts[3], ts[4]) if fs else None
    counts = TMoE(n_dev=n, tokens_per_rank=T, d=d, f=f)._counts(T)
    x, w1, w2, sp = kern.pad_to_tiles(*ts[:3], shared)
    assert x.shape[2] % kern.TILE == 0 and w2.shape[1] % kern.TILE == 0
    if sp is not None:
        assert sp[2].shape[0] % kern.TILE == 0
    kw = dict(counts=counts, block_tokens=16, wire_i8=wire_i8)
    want = kern.moe_dispatch_combine_ref(*ts[:3], shared=shared, **kw)
    got = kern.moe_dispatch_combine_ref(x, w1, w2, shared=sp, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert bool((g[..., d:] == 0).all())
        assert rel_err(g[..., :d], w) <= 1e-6
    if (d, f, fs or kern.TILE) == (64, 64, 64):
        assert x is ts[0] and w1 is ts[1] and w2 is ts[2]
