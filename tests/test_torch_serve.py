"""The port's models and serving engine against the JAX package, on the CPU.

Weights come from the reference's ``init_params`` and cross as numpy
(``params_from_numpy``); token ids are made with numpy from a seed. The
reference engine's decode is wrong whenever its cache is longer than the
prompt (ROADMAP queue 3), so the port's decode is held against the
reference's ``forward`` over the grown sequence — the function the
engine means to compute — never against the reference engine.

Tolerances, max-abs-normalised: 1e-5 in float32 (the same arithmetic in
another library); 2e-2 in bfloat16 (the two libraries round the bf16
intermediates at other places), where tokens are not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jcells
from repro.configs import get_arch as jarch
from repro.configs import reduced as jreduced
from repro.models import StepOptions as JOpts
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_step as jprefill
from repro.models import layers as jlayers
from repro.models.model import lm_logits as jlogits
from repro_torch.configs import ARCHS, SHAPES, cells, get_arch, reduced
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import kv_shuttle as kern
from repro_torch.models import (StepOptions, decode_step, forward,
                                init_params, params_from_numpy, prefill_step)
from repro_torch.models import layers as tlayers
from repro_torch.models.model import lm_logits
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from torch_port_helpers import rel_err

DENSE = ["llama3.2-1b", "phi3-mini-3.8b", "granite-20b", "stablelm-12b",
         "llava-next-mistral-7b"]


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_config_copies_equal_reference(name):
    j, t = JARCHS[name], ARCHS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.repeat_unit, t.num_repeats, t.hd, t.vocab_padded) \
        == (j.repeat_unit, j.num_repeats, j.hd, j.vocab_padded)
    assert dataclasses.asdict(reduced(t, dtype="float32")) \
        == dataclasses.asdict(jreduced(j, dtype="float32"))
    assert get_arch(name) is t


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert cells() == jcells()


# ------------------------------------------------------------ shared set-up


def pair(name="llama3.2-1b", dtype="float32", **over):
    jcfg = jreduced(jarch(name), dtype=dtype, **over)
    tcfg = reduced(get_arch(name), dtype=dtype, **over)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def jlast_logits(jp, jcfg, toks, opts=None):
    x, _ = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg, None, opts)
    return np.asarray(jlogits(jp, x[:, -1:], jcfg, None))


@pytest.fixture(scope="module")
def llama():
    return pair()


# ------------------------------------------------------------------- models


@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_equal_reference(name):
    jcfg, tcfg, jp, tp = pair(name)
    toks = prompts(tcfg, 2, 12)
    jx, _ = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg, None)
    want = np.asarray(jlogits(jp, jx, jcfg, None))
    tx, _ = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    got = lm_logits(tp, tx, tcfg)
    assert got.shape == want.shape and rel_err(got, want) <= 1e-5


def test_params_cross_leaf_for_leaf(llama):
    jcfg, tcfg, jp, tp = llama
    jl = jax.tree_util.tree_leaves_with_path(jp)
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(prefix + (k,), v)
            else:
                flat[prefix + (k,)] = v
    walk((), tp)
    assert len(flat) == len(jl)
    for path, leaf in jl:
        key = tuple(p.key for p in path)
        assert tuple(flat[key].shape) == leaf.shape
        assert np.array_equal(flat[key].numpy(), np.asarray(leaf))


@pytest.mark.parametrize("seq_len", [8, 12])
def test_prefill_logits_and_cache_equal_reference_when_it_fits(llama, seq_len):
    """With the cache no longer than the prompt (Sc <= S) both keep the
    last Sc positions, so the caches are equal too."""
    jcfg, tcfg, jp, tp = llama
    toks = prompts(tcfg, 2, 12, seed=1)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, None,
                      seq_len=seq_len)
    tl, tc = prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                          seq_len=seq_len)
    assert rel_err(tl, np.asarray(jl)) <= 1e-5
    for leaf in ("k", "v"):
        assert tc["s0"][leaf].shape == jc["s0"][leaf].shape
        assert rel_err(tc["s0"][leaf], np.asarray(jc["s0"][leaf])) <= 1e-5
    assert np.array_equal(tc["s0"]["kpos"].numpy(), np.asarray(jc["s0"]["kpos"]))


def test_decode_equals_reference_forward_over_the_grown_sequence(llama):
    """Sc > S (every engine cache): each decode step's logits equal the
    reference's forward over the prompt plus the tokens decoded so far —
    read off one causal forward over the final sequence, whose position
    p sees positions <= p only."""
    jcfg, tcfg, jp, tp = llama
    toks = prompts(tcfg, 2, 10, seed=2)
    tl, cache = prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                             seq_len=32)
    assert (cache["s0"]["kpos"][:, 10:] < 0).all()
    got, seq = [tl], toks
    tok = torch.argmax(tl[:, -1], dim=-1)
    for i in range(4):
        seq = np.concatenate([seq, tok.numpy()[:, None]], axis=1)
        before = cache["s0"]["k"].clone()
        logits, cache2 = decode_step(tp, cache, tok[:, None], 10 + i, tcfg)
        assert torch.equal(cache["s0"]["k"], before)      # left unchanged
        cache = cache2
        got.append(logits)
        tok = torch.argmax(logits[:, -1], dim=-1)
    jx, _ = jforward(jp, {"tokens": jnp.asarray(seq)}, jcfg, None)
    want = np.asarray(jlogits(jp, jx, jcfg, None))
    for i, logits in enumerate(got):
        assert rel_err(logits[:, -1], want[:, 9 + i]) <= 1e-5


def test_flash_attention_equals_reference(llama):
    """The blockwise path (a loop where the reference scans), forced with
    StepOptions(flash_threshold=8, kv_block=8) on a 24-token prompt."""
    jcfg, tcfg, jp, tp = llama
    toks = prompts(tcfg, 2, 24, seed=3)
    jo = JOpts(flash_threshold=8, kv_block=8, remat=False)
    to = StepOptions(flash_threshold=8, kv_block=8)
    want = jlast_logits(jp, jcfg, toks, jo)
    tx, _ = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, None, to)
    assert rel_err(lm_logits(tp, tx[:, -1:], tcfg), want) <= 1e-5
    tx_dense, _ = forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert rel_err(tx, tx_dense) <= 1e-5


@pytest.mark.parametrize("kind,window,chunk", [("attn", 0, 0),
                                               ("local_attn", 5, 0),
                                               ("chunked_attn", 0, 8),
                                               ("global_attn", 0, 0)])
@pytest.mark.parametrize("flash", [False, True])
def test_attention_kinds_equal_reference(kind, window, chunk, flash):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    pos = np.arange(16)
    kw = dict(kind=kind, window=window, chunk=chunk,
              flash_threshold=4 if flash else 8192, kv_block=4)
    want = jlayers.attention(*map(jnp.asarray, (q, k, v, pos, pos)), **kw)
    got = tlayers.attention(*map(torch.from_numpy, (q, k, v, pos, pos)), **kw)
    assert rel_err(got, want) <= 1e-5


def test_flash_with_a_ragged_last_block_equals_dense_reference():
    """10 keys in blocks of 4: the padded slots of the last block are
    masked (the reference's flash path attends to them, ROADMAP queue 3),
    so the blockwise path equals the reference's dense attention."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 10, 2, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(10)
    want = jlayers.attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                             flash_threshold=10**9)
    got = tlayers.attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                            flash_threshold=4, kv_block=4)
    assert rel_err(got, want) <= 1e-5


def test_attention_masks_empty_cache_slots():
    """The one deliberate difference: a key slot at a negative position
    (an empty cache slot) is never attended."""
    kpos = torch.tensor([0, 1, 2, -10**9, -10**9])
    m = tlayers.attn_mask(torch.tensor([2]), kpos, "attn")
    assert m.tolist() == [[True, True, True, False, False]]
    jm = jlayers.attn_mask(jnp.asarray([2]), jnp.asarray(kpos.numpy()), "attn")
    assert np.asarray(jm).tolist() == [[True, True, True, True, True]]


def test_bf16_logits_near_reference():
    jcfg, tcfg, jp, tp = pair(dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = prompts(tcfg, 2, 12, seed=5)
    tl, _ = prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                         seq_len=16)
    assert rel_err(tl, jlast_logits(jp, jcfg, toks)) <= 2e-2


def test_init_params_shapes_match_reference():
    cfg = reduced(get_arch("llama3.2-1b"))
    tp = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jreduced(
        jarch("llama3.2-1b"))))
    shapes = jax.tree.map(lambda a: a.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    assert tp["embed"].dtype == torch.bfloat16
    again = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["blocks"]["s0"]["attn"]["q"],
                       tp["blocks"]["s0"]["attn"]["q"])


# ------------------------------------------------------------------- engine


def test_greedy_generate_equals_a_no_cache_loop_over_reference_forward(llama):
    jcfg, tcfg, jp, tp = llama
    toks = prompts(tcfg, 2, 9, seed=6)
    eng = Engine(tcfg, tp, ServeConfig(max_seq=32))
    got = eng.generate({"tokens": torch.from_numpy(toks)}, 5).numpy()
    last = jax.jit(lambda p, t: jlogits(
        p, jforward(p, {"tokens": t}, jcfg, None)[0][:, -1:], jcfg, None))
    seq = toks
    for _ in range(5):
        nxt = np.asarray(last(jp, jnp.asarray(seq)))[:, -1].argmax(-1)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    assert np.array_equal(got, seq[:, 9:])
    m = eng.metrics.snapshot()
    assert m["counters"]["serve.tokens_generated"] == 2 * 4
    assert m["counters"]["serve.prefill_tokens"] == 2 * 9
    assert m["histograms"]["serve.decode_step_ms"]["count"] == 4


@pytest.mark.parametrize("kw", [{}, dict(fused=True, counter=True, kv_chunk=16),
                                dict(fused=True, kv_chunk=7),
                                dict(chained=False)], ids=str)
def test_shuttled_handoff_is_bit_equal_to_the_direct_one(llama, kw):
    jcfg, tcfg, jp, tp = llama
    b = {"tokens": torch.from_numpy(prompts(tcfg, 2, 12, seed=7))}
    eng = Engine(tcfg, tp, ServeConfig(max_seq=20))
    toks = eng.generate(b, 6)
    direct = eng.prefill_remote(b)
    h = eng.prefill_remote(b, shuttle_mesh=VirtualMesh(2, device="cpu"), **kw)
    for leaf, t in direct["cache"]["s0"].items():
        assert torch.equal(h["cache"]["s0"][leaf], t), leaf
    assert torch.equal(eng.decode_from_handoff(h, 6), toks)
    assert torch.equal(eng.decode_from_handoff(direct, 6), toks)
    assert eng.metrics.snapshot()["counters"]["serve.kv_handoffs"] == 2
    assert kern.launches() == 0                 # the plain version, on cpu
    with pytest.raises(ValueError, match="2-rank"):
        eng.prefill_remote(b, shuttle_mesh=VirtualMesh(3, device="cpu"))
    # a mesh off the cache's device is refused, never copied across
    with pytest.raises(ValueError, match="not on the cache's device"):
        eng.prefill_remote(b, shuttle_mesh=VirtualMesh(2, device="meta"))
    assert eng.metrics.snapshot()["counters"]["serve.kv_handoffs"] == 2


def test_serve_requests_equal_generate_alone(llama):
    jcfg, tcfg, jp, tp = llama
    rng = np.random.default_rng(8)
    lens = [3, 7, 5, 7, 12]
    reqs = [Request(r, rng.integers(0, tcfg.vocab_size, n).tolist(),
                    max_new_tokens=2 + r) for r, n in enumerate(lens)]
    eng = Engine(tcfg, tp, ServeConfig(max_seq=32))
    sched = Scheduler(token_budget=16, max_batch=3, metrics=eng.metrics)
    for r in reqs:
        sched.submit(r)
    done = eng.serve(sched)
    assert sorted(done) == list(range(len(reqs)))
    for r in reqs:
        alone = Engine(tcfg, tp, ServeConfig(max_seq=32)).generate(
            {"tokens": torch.tensor([r.prompt])}, r.max_new_tokens)
        assert done[r.rid].tolist() == alone[0].tolist(), r.rid
    c = eng.metrics.snapshot()["counters"]
    assert c["sched.finished"] == c["sched.submitted"] == len(reqs)
    assert c["serve.prefills"] == len(reqs)
    assert c["serve.tokens_generated"] == sum(r.max_new_tokens - 1
                                              for r in reqs)


def test_sampling_streams_advance_and_replay():
    """The reference's test_sampling_keys_advance_between_batches, for the
    port against itself."""
    cfg = reduced(get_arch("llama3.2-1b"))
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(prompts(cfg, 4, 16))}

    def engine():
        return Engine(cfg, params, ServeConfig(max_seq=64, temperature=1.0,
                                               seed=7))

    eng = engine()
    a, b = eng.generate(batch, 8), eng.generate(batch, 8)
    assert not torch.equal(a, b)                  # the stream advanced
    assert torch.equal(a, engine().generate(batch, 8))   # and replays
    eng3 = engine()
    c = eng3.decode_from_handoff(eng3.prefill_remote(batch), 8)
    assert torch.equal(a, c)                      # handoff draws alike
    small = prompts(cfg, 3, 4, seed=1)

    def serve(max_batch, rids):
        e = engine()
        s = Scheduler(token_budget=12, max_batch=max_batch)
        for r in rids:
            s.submit(Request(r, small[r].tolist(), max_new_tokens=4 + r))
        return e.serve(s), e

    together, eng4 = serve(3, [0, 1, 2])
    alone, _ = serve(1, [1])
    assert torch.equal(together[1], alone[1])
    assert not torch.equal(together[0][:4], together[1][:4])
    assert torch.equal(a, eng4.generate(batch, 8))   # serve left it alone


def test_chip_smoke_serve_phase_on_the_cpu():
    """The smoke's serve phase at the reduced size on the CPU: the
    handoffs are the plain version's, so no launch is counted."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    assert chip_smoke.phase_serve("cpu", chip_smoke.engine_config(small=True),
                                  chip_smoke.serve_shape(small=True)) == {}
    cfg = chip_smoke.engine_config()
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (16, 2048, 128256)
    assert chip_smoke.serve_shape() == (8, 512, 32)
