"""The port's encoder-decoder (whisper) against the JAX package, on the
CPU: the encoder over frame embeddings, cross attention in every decoder
block, the ``ck``/``cv`` cache, the engine and its handoff through the
``kv_cache_shuttle`` kernel (its plain version here).

Reduced config (2 encoder layers over 8 frames, one decoder layer, d =
64) in float32; weights from the reference's ``init_params`` cross
through ``params_from_numpy``, token ids and frames come from numpy with a
seed. A decode step is held against the reference's ``decode_step`` on a
cache as long as the prompt (there the two caches hold the same rows),
and against the reference's ``forward`` over the grown sequence on the
engine's longer cache (where the reference's own decode goes wrong,
ROADMAP §3).

Tolerances, max-abs-normalised: 1e-5 in float32, as for the attention
models (the same arithmetic in another library, no carried state); 2e-2
in bfloat16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jarch
from repro.configs import reduced as jreduced
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill_step as jprefill
from repro.models.model import encode as jencode
from repro.models.model import lm_logits as jlogits
from repro_torch.configs import get_arch, reduced
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import kv_shuttle as kern
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (decode_step, forward, init_params,
                                params_from_numpy, prefill_step)
from repro_torch.models.model import encode, lm_logits
from repro_torch.serve import Engine, ServeConfig
from torch_port_helpers import rel_err

NAME = "whisper-large-v3"
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def pair(dtype="float32"):
    jcfg = jreduced(jarch(NAME), dtype=dtype)
    tcfg = reduced(get_arch(NAME), dtype=dtype)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "frames": rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def assert_caches_equal(tc, jc, tol=TOL):
    jc = jax.tree.map(np.asarray, jc)
    assert tc.keys() == jc.keys()
    for blk, node in jc.items():
        assert tc[blk].keys() == node.keys()
        for leaf, want in node.items():
            got = tc[blk][leaf]
            assert tuple(got.shape) == want.shape, (blk, leaf)
            if leaf == "kpos":
                assert np.array_equal(got.numpy(), want)
            else:
                assert rel_err(got, want) <= tol, (blk, leaf)


def test_encoder_equals_reference():
    jcfg, tcfg, jp, tp = pair()
    frames = batch(tcfg, 2, 4, seed=1)["frames"]
    want = jencode(jp, jnp.asarray(frames), jcfg, None)
    got = encode(tp, torch.from_numpy(frames), tcfg)
    assert got.shape == want.shape and rel_err(got, want) <= TOL


def test_forward_logits_equal_reference():
    jcfg, tcfg, jp, tp = pair()
    b = batch(tcfg, 2, 12, seed=2)
    jx, _ = jforward(jp, jbatch(b), jcfg, None)
    tx, _ = forward(tp, tbatch(b), tcfg)
    assert rel_err(lm_logits(tp, tx, tcfg),
                   np.asarray(jlogits(jp, jx, jcfg, None))) <= TOL


@pytest.mark.parametrize("S", [6, 13])
def test_prefill_and_decode_equal_reference(S):
    """``prefill_step``'s logits and every cache leaf (``k``, ``v``,
    ``kpos``, ``ck``, ``cv``) with the cache as long as the prompt, then 3
    ``decode_step``s against the reference's on the same tokens, each
    step's logits and cache."""
    jcfg, tcfg, jp, tp = pair()
    b = batch(tcfg, 2, S, seed=S)
    jl, jc = jprefill(jp, jbatch(b), jcfg, None, seq_len=S)
    tl, tc = prefill_step(tp, tbatch(b), tcfg, seq_len=S)
    assert rel_err(tl, np.asarray(jl)) <= TOL
    assert_caches_equal(tc, jc)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for i in range(3):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, None]), jnp.int32(S + i),
                         jcfg, None)
        tl, tc = decode_step(tp, tc, torch.from_numpy(tok[:, None]).long(),
                             S + i, tcfg)
        assert rel_err(tl, np.asarray(jl)) <= TOL, i
        assert_caches_equal(tc, jc)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)


def test_decode_equals_reference_forward_over_the_grown_sequence():
    """The engine's cache (longer than the prompt): each of 4 decode steps
    equals the reference's forward over the prompt plus the tokens decoded
    so far, on the same frames; the cross cache is left as prefill made
    it."""
    jcfg, tcfg, jp, tp = pair()
    b = batch(tcfg, 2, 9, seed=3)
    tl, cache = prefill_step(tp, tbatch(b), tcfg, seq_len=16)
    ck = cache["s0"]["ck"].clone()
    got, seq = [tl], b["tokens"]
    for i in range(4):
        tok = torch.argmax(got[-1][:, -1], dim=-1)
        seq = np.concatenate([seq, tok.numpy()[:, None]], axis=1)
        logits, cache = decode_step(tp, cache, tok[:, None], 9 + i, tcfg)
        got.append(logits)
    assert torch.equal(cache["s0"]["ck"], ck)
    jx, _ = jforward(jp, {"tokens": jnp.asarray(seq),
                          "frames": jnp.asarray(b["frames"])}, jcfg, None)
    want = np.asarray(jlogits(jp, jx, jcfg, None))
    for i, logits in enumerate(got):
        assert rel_err(logits[:, -1], want[:, 8 + i]) <= TOL, i


def test_bf16_logits_near_reference():
    jcfg, tcfg, jp, tp = pair("bfloat16")
    b = batch(tcfg, 2, 12, seed=5)
    jl, _ = jprefill(jp, jbatch(b), jcfg, None, seq_len=16)
    tl, tc = prefill_step(tp, tbatch(b), tcfg, seq_len=16)
    assert tc["s0"]["ck"].dtype == torch.bfloat16
    assert rel_err(tl, np.asarray(jl, np.float32)) <= 2e-2


def test_init_params_and_cache_shapes_match_reference():
    cfg = reduced(get_arch(NAME))
    tp = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jcfg = jreduced(jarch(NAME))
    jp = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp) \
        == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    assert set(tp["enc"]) == {"pos", "blocks", "final_norm"}
    assert "cross" in tp["blocks"]["s0"] and "cross" not in tp["enc"]["blocks"]
    b = batch(cfg, 2, 5)
    _, jc = jax.eval_shape(lambda p: jprefill(p, jbatch(b), jcfg, None,
                                              seq_len=7), jp)
    _, tc = prefill_step(tp, tbatch(b), cfg, seq_len=7)
    assert jax.tree.map(lambda t: tuple(t.shape), tc) \
        == jax.tree.map(lambda a: a.shape, jc)


# ------------------------------------------------------------------- engine


def test_generate_equals_a_no_cache_loop_over_reference_forward():
    jcfg, tcfg, jp, tp = pair()
    b = batch(tcfg, 2, 7, seed=6)
    got = Engine(tcfg, tp, ServeConfig(max_seq=16)).generate(tbatch(b), 5)
    last = jax.jit(lambda p, t, f: jlogits(p, jforward(
        p, {"tokens": t, "frames": f}, jcfg, None)[0][:, -1:], jcfg, None))
    seq = b["tokens"]
    for _ in range(5):
        nxt = np.asarray(last(jp, jnp.asarray(seq),
                              jnp.asarray(b["frames"])))[:, -1].argmax(-1)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    assert np.array_equal(got.numpy(), seq[:, 7:])


@pytest.mark.parametrize("kw", [{}, dict(fused=True, counter=True, kv_chunk=16)],
                         ids=str)
def test_shuttled_handoff_is_bit_equal_to_the_direct_one(kw):
    """``prefill_remote`` sends ``[k; v]`` and ``[ck; cv]`` through the
    shuttle: every leaf of the handoff equals the direct handoff bit for
    bit, and ``decode_from_handoff`` gives ``generate``'s tokens."""
    jcfg, tcfg, jp, tp = pair()
    b = tbatch(batch(tcfg, 2, 7, seed=7))
    eng = Engine(tcfg, tp, ServeConfig(max_seq=16))
    toks = eng.generate(b, 5)
    direct = eng.prefill_remote(b)
    h = eng.prefill_remote(b, shuttle_mesh=VirtualMesh(2, device="cpu"), **kw)
    assert set(h["cache"]["s0"]) == {"k", "v", "kpos", "ck", "cv"}
    for leaf, t in direct["cache"]["s0"].items():
        assert torch.equal(h["cache"]["s0"][leaf], t), leaf
    assert torch.equal(eng.decode_from_handoff(h, 5), toks)
    assert kern.launches() == 0                 # the plain version, on cpu


def test_serve_entry_point_on_the_cpu(capsys):
    for extra in ([], ["--disaggregated"]):
        launch_serve.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "5", "--new-tokens", "3"] + extra)
        out = capsys.readouterr().out
        assert f"{NAME}-smoke on cpu: 6 tokens" in out
        assert ("mode=disaggregated" if extra else "mode=monolithic") in out
