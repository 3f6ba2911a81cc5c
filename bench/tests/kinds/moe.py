"""Test hooks of the MoE layer kind (``bench/layers/moe.py``): its widths
and sizes cut to a size the CPU runs in a blink, the faults it can have,
and what :func:`plant` puts in ``moe_dispatch_combine``'s place."""
import torch

from bench.reference import common
from bench.reference import moe as ref

CONFIG = dict(hidden_size=64, moe_intermediate_size=64)
PARAMS = {"tokens_per_rank": {"fixed": 32}}
FAULTS = ("unchanged", "half", "no_exchange", "altered", "no_shared")
# the keys of its own that each mix of the kind holds
MIX_KEYS = ("directive", "shared_expert")


def faults(mix):
    """The faults a cell of ``mix`` can have: the shared expert's output
    dropped only where the mix has one."""
    return tuple(f for f in FAULTS
                 if f != "no_shared" or mix.get("shared_expert", False))


def _broken(fault, orig):
    """``moe_dispatch_combine`` with ``fault`` planted in its output."""
    def run(x, w1, w2, *, counts, shared=None, **kw):
        out = orig(x, w1, w2, counts=counts, shared=shared, **kw)
        y, ys = out if shared is not None else (out, None)
        y = y.clone()
        T = x.shape[1]
        if fault == "unchanged":          # the layer hands back its input
            y = x.clone()
            ys = None if ys is None else torch.zeros_like(ys)
        elif fault == "half":             # half of each rank's rows left out
            y[:, T // 2:] = 0
        elif fault == "no_exchange":      # only each rank's own expert's rows
            off = 0
            for e, c in enumerate(counts):
                for r in range(x.shape[0]):
                    if r != e:
                        y[r, off:off + c] = 0
                off += c
        elif fault == "altered":          # one row altered where produced
            y[0, -1] *= 1.001
        elif fault == "no_shared":        # the shared expert's output dropped
            ys = torch.zeros_like(ys)
        return (y, ys) if shared is not None else y
    return run


def _control(x, w1, w2, *, counts, shared=None, wire_i8=False, **kw):
    """The MoE layer's plain reference at TF32, in the kernel entry's
    place and layout: y (n, T, d), and with ``shared`` the shared
    expert's output apart, as the kernel hands it back."""
    y = torch.empty_like(x)
    for off, c, block in ref.blocks(x, w1, w2, counts, wire_i8=wire_i8,
                                    mode="tf32"):
        y[:, off:off + c] = block
    if shared is None:
        return y
    xs, s1, s2 = shared
    with common.precision(x.device, "tf32"):
        return y, ref.swiglu(xs, s1, s2, "tf32")


def plant(monkeypatch, what):
    """Put ``what`` (a fault of :data:`FAULTS`, or "control") in the place
    of ``moe_dispatch_combine``."""
    from repro_torch.kernels import moe_dispatch
    orig = moe_dispatch.moe_dispatch_combine
    monkeypatch.setattr(moe_dispatch, "moe_dispatch_combine",
                        _control if what == "control"
                        else _broken(what, orig))
