"""Test hooks of the cache-handoff layer kind (``bench/layers/kv_cache.py``):
its widths and sizes cut to a size the CPU runs in a blink, the faults it
can have, and what :func:`plant` puts in ``kv_cache_shuttle``'s place,
which ``Engine._shuttle_cache`` imports at each call."""
import torch

from bench.reference import kv_cache as ref

CONFIG = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
              num_hidden_layers=2)
PARAMS = {"prompt_tokens": {"lognormal_quantiles": {
    "median": 40, "sigma": 0.6, "min": 8, "max": 160}}}
FAULTS = ("unchanged", "half", "no_exchange", "altered")
# the keys of its own that each mix of the kind holds
MIX_KEYS = ("shuttle",)
# the control's precision: the one below the cache's bfloat16
CONTROL_DTYPE = torch.float8_e4m3fn


def _broken(fault, orig):
    """``kv_cache_shuttle`` with ``fault`` planted in its output."""
    def run(kv, **kw):
        k, v = (t.clone() for t in orig(kv, **kw))
        N = k.shape[1]
        if fault == "unchanged":          # the decode rank's rows untouched
            k.zero_(), v.zero_()
        elif fault == "half":             # half of each leaf's rows left out
            k[1, N // 2:] = 0
            v[1, N // 2:] = 0
        elif fault == "no_exchange":      # copied, never sent
            k[0], v[0] = k[1].clone(), v[1].clone()
            k[1], v[1] = 0, 0
        elif fault == "altered":          # one row altered where it lands,
            k[1, -1] *= 1.01              # by an ulp of bfloat16 or more
        return k, v
    return run


def _control(kv, **kw):
    """The handoff's plain reference in ``kv_cache_shuttle``'s place, each
    element rounded through the precision below the cache's: K, V each
    (2, N, w), the decode rank's row filled."""
    N = kv.shape[1] // 2
    k = kv.new_zeros((2, N, kv.shape[2]))
    v = torch.zeros_like(k)
    k[1] = ref.copy(kv[0, :N], CONTROL_DTYPE)
    v[1] = ref.copy(kv[0, N:], CONTROL_DTYPE)
    return k, v


def plant(monkeypatch, what):
    """Put ``what`` (a fault of :data:`FAULTS`, or "control") in the place
    of ``kv_cache_shuttle``."""
    from repro_torch.kernels import kv_shuttle
    orig = kv_shuttle.kv_cache_shuttle
    monkeypatch.setattr(kv_shuttle, "kv_cache_shuttle",
                        _control if what == "control"
                        else _broken(what, orig))
