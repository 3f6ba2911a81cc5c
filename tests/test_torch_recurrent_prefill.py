"""The recurrent kinds' prefill and decode against the JAX package on the
CPU, with ``tests/test_torch_recurrent.py``'s set-up and tolerance
(``tests/torch_recurrent_helpers.py``): a file of its own, so that no
recurrent test file runs long under the tier-1 command's ``--dist
loadfile`` (a file a worker)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as jdecode
from repro.models import prefill_step as jprefill
from repro_torch.models import decode_step, prefill_step
from torch_port_helpers import rel_err
from torch_recurrent_helpers import TOL, assert_caches_equal, pair, prompts


@pytest.mark.parametrize("name,S", [("xlstm-350m", 5), ("xlstm-350m", 13),
                                    ("xlstm-350m", 24),
                                    ("recurrentgemma-9b", 21),
                                    ("recurrentgemma-9b", 37)])
def test_prefill_and_decode_equal_reference(name, S):
    """``prefill_step``'s logits and every cache leaf (the states, the
    conv tail, the local-attention ring), then 3 ``decode_step``s, each
    step's logits and cache, against the reference on the same tokens.
    xLSTM: one short chunk, a padded one, whole chunks. RecurrentGemma:
    prompts past the window of 16, so the ring holds real positions only
    (a prompt shorter than the ring is where the reference's attention
    cache goes wrong, ROADMAP §3: that case is held through ``forward``
    in the next test)."""
    jcfg, tcfg, jp, tp = pair(name)
    toks = prompts(tcfg, 2, S, seed=S)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, None,
                      seq_len=S)
    tl, tc = prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                          seq_len=S)
    assert rel_err(tl, np.asarray(jl)) <= TOL
    assert_caches_equal(tc, jc)
    jstep = jax.jit(lambda p, c, t, pos: jdecode(p, c, t, pos, jcfg, None))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for i in range(3):
        jl, jc = jstep(jp, jc, jnp.asarray(tok[:, None]), jnp.int32(S + i))
        tl, tc = decode_step(tp, tc, torch.from_numpy(tok[:, None]).long(),
                             S + i, tcfg)
        assert rel_err(tl, np.asarray(jl)) <= TOL, i
        assert_caches_equal(tc, jc)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
