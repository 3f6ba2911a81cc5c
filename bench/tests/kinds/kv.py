"""Test hooks of the KV-handoff layer kind (``bench/layers/kv.py``): its
widths and sizes cut to a size the CPU runs in a blink, the faults it can
have, and what :func:`plant` puts in ``kv_shuttle``'s place."""
import torch

from bench.reference import kv as ref

CONFIG = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2)
PARAMS = {"prompt_tokens": {"lognormal_quantiles": {
    "median": 40, "sigma": 0.6, "min": 8, "max": 160}}}
FAULTS = ("unchanged", "half", "no_exchange", "altered")
# the keys of its own that each mix of the kind holds
MIX_KEYS = ("directive",)


def _broken(fault, orig):
    """``kv_shuttle`` with ``fault`` planted in its output."""
    def run(x, wk, wv, **kw):
        k, v = (t.clone() for t in orig(x, wk, wv, **kw))
        T = x.shape[1]
        if fault == "unchanged":          # the decode rank's cache untouched
            k.zero_(), v.zero_()
        elif fault == "half":
            k[1, T // 2:] = 0
            v[1, T // 2:] = 0
        elif fault == "no_exchange":      # computed, never sent
            k[0], v[0] = k[1].clone(), v[1].clone()
            k[1], v[1] = 0, 0
        elif fault == "altered":
            k[1, -1] *= 1.001
        return k, v
    return run


def _control(x, wk, wv, **kw):
    """The handoff's plain reference at TF32 in ``kv_shuttle``'s place:
    K, V each (2, T, dk), the decode rank's row filled."""
    k = x.new_zeros((2, x.shape[1], wk.shape[1]))
    v = torch.zeros_like(k)
    k[1], v[1] = ref.handoff(x[0], wk, wv, "tf32")
    return k, v


def plant(monkeypatch, what):
    """Put ``what`` (a fault of :data:`FAULTS`, or "control") in the place
    of ``kv_shuttle``."""
    from repro_torch.kernels import kv_shuttle
    orig = kv_shuttle.kv_shuttle
    monkeypatch.setattr(kv_shuttle, "kv_shuttle",
                        _control if what == "control"
                        else _broken(what, orig))
