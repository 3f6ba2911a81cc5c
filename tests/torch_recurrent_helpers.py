"""Set-up the recurrent parity files share
(``tests/test_torch_recurrent*.py``): the reduced xLSTM and
RecurrentGemma in float32 in both packages with the reference's weights
carried over, seeded prompts, and the cache check at ``TOL``
(max-abs-normalised; see ``tests/test_torch_recurrent.py``). Imports
JAX."""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_arch as jarch
from repro.configs import reduced as jreduced
from repro.models import init_params as jinit
from repro_torch.configs import get_arch, reduced
from repro_torch.models import params_from_numpy
from torch_port_helpers import rel_err

KINDS = ["xlstm-350m", "recurrentgemma-9b"]
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def pair(name, dtype="float32"):
    jcfg = jreduced(jarch(name), dtype=dtype)
    tcfg = reduced(get_arch(name), dtype=dtype)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def leaves(cache):
    return {(blk, leaf): v for blk, node in cache.items()
            for leaf, v in node.items()}


def assert_caches_equal(tc, jc, tol=TOL):
    t, j = leaves(tc), leaves(jax.tree.map(np.asarray, jc))
    assert t.keys() == j.keys()
    for key, want in j.items():
        got = t[key]
        assert tuple(got.shape) == want.shape, key
        assert got.dtype == {np.dtype("float32"): torch.float32,
                             np.dtype("int32"): torch.int32}[want.dtype], key
        if want.dtype == np.int32:
            assert np.array_equal(got.numpy(), want), key
        else:
            assert rel_err(got, want) <= tol, key
