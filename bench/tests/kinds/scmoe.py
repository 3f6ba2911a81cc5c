"""Test hooks of the ScMoE layer kind (``bench/layers/scmoe.py``): its
widths and sizes cut to a size the CPU runs in a blink, the faults it can
have, and what :func:`plant` puts in the place of ``moe_dispatch_combine``
(or, for a wrong pick, of the workload's pick)."""
import torch

from bench.reference import common
from bench.reference import scmoe as ref

CONFIG = dict(hidden_size=64, expert_ffn_hidden_size=64, ffn_hidden_size=128,
              n_routed_experts=16, zero_expert_num=8, moe_topk=6,
              num_layers=2)
PARAMS = {"tokens_per_rank": {"fixed": 16}}
FAULTS = ("unchanged", "half", "no_exchange", "altered", "no_shared",
          "wrong_pick")
# the keys of its own that each mix of the kind holds
MIX_KEYS = ("directive",)


def _broken(fault, orig):
    """``moe_dispatch_combine`` with ``fault`` planted in its output."""
    def run(x, w1, w2, *, counts, shared=None, **kw):
        y, ys = orig(x, w1, w2, counts=counts, shared=shared, **kw)
        y, ys = y.clone(), ys.clone()
        if fault == "unchanged":          # the rows come back as they went
            y, ys = x.clone(), torch.zeros_like(ys)
        elif fault == "half":             # half of each source's rows lost
            for s, row in enumerate(counts):
                r = sum(row)
                y[s, r // 2:r] = 0
        elif fault == "no_exchange":      # only each rank's own expert's rows
            for s, row in enumerate(counts):
                off = 0
                for e, c in enumerate(row):
                    if e != s:
                        y[s, off:off + c] = 0
                    off += c
        elif fault == "altered":          # one row of FFN1 altered
            ys[0, 0] *= 1.001
        elif fault == "no_shared":        # FFN1's output dropped
            ys = torch.zeros_like(ys)
        return y, ys
    return run


def _control(x, w1, w2, *, counts, shared=None, **kw):
    """The kernel entry's plain reference at TF32, in its place and layout:
    each source's runs through their expert, FFN1 apart."""
    y = torch.zeros_like(x)
    with common.precision(x.device, "tf32"):
        for s, row in enumerate(counts):
            off = 0
            for e, c in enumerate(row):
                if c:
                    y[s, off:off + c] = ref.swiglu(x[s, off:off + c], w1[e],
                                                   w2[e], "tf32")
                off += c
        xs, s1, s2 = shared
        return y, ref.swiglu(xs, s1, s2, "tf32")


def _wrong_pick(self, scores, b):
    """The 13th of 12 (the (k + 1)-th) picked in place of the best."""
    top = torch.topk(scores + b, self.topk + 1, dim=-1).indices
    return top[..., 1:]


def plant(monkeypatch, what):
    """Put ``what`` (a fault of :data:`FAULTS`, or "control") in the place
    of ``moe_dispatch_combine``, or of ``ScMoEStep._pick``."""
    from repro_torch.kernels import moe_dispatch
    if what == "wrong_pick":
        from repro_torch.workloads.scmoe import ScMoEStep
        monkeypatch.setattr(ScMoEStep, "_pick", _wrong_pick)
        return
    orig = moe_dispatch.moe_dispatch_combine
    monkeypatch.setattr(moe_dispatch, "moe_dispatch_combine",
                        _control if what == "control"
                        else _broken(what, orig))
