"""What the benchmark's tests put in the program's place underneath a
whole run: the port's kernel entry with a fault planted in its output,
or the control, the plain reference at TF32 (the precision below the
configuration's float32 with TF32 off) computed where the kernel would
run. The workloads import their kernel entry when they build, so
:func:`plant` patches it before the run's set-up."""
import torch

from bench.reference import common
from bench.reference import kv as kv_ref
from bench.reference import moe as moe_ref

# the faults each layer kind can have, planted where the output is made
FAULTS = {"moe": ("unchanged", "half", "no_exchange", "altered",
                  "no_shared"),
          "kv": ("unchanged", "half", "no_exchange", "altered")}


def _break_moe(fault, orig):
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


def _control_moe(x, w1, w2, *, counts, shared=None, wire_i8=False, **kw):
    """The MoE layer's plain reference at TF32, in the kernel entry's
    place and layout: y (n, T, d), and with ``shared`` the shared
    expert's output apart, as the kernel hands it back."""
    y = torch.empty_like(x)
    for off, c, block in moe_ref.blocks(x, w1, w2, counts, wire_i8=wire_i8,
                                        mode="tf32"):
        y[:, off:off + c] = block
    if shared is None:
        return y
    xs, s1, s2 = shared
    with common.precision(x.device, "tf32"):
        return y, moe_ref.swiglu(xs, s1, s2, "tf32")


def _break_kv(fault, orig):
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


def _control_kv(x, wk, wv, **kw):
    """The handoff's plain reference at TF32 in ``kv_shuttle``'s place:
    K, V each (2, T, dk), the decode rank's row filled."""
    k = x.new_zeros((2, x.shape[1], wk.shape[1]))
    v = torch.zeros_like(k)
    k[1], v[1] = kv_ref.handoff(x[0], wk, wv, "tf32")
    return k, v


def plant(monkeypatch, layer, what):
    """Put ``what`` (a fault of ``FAULTS[layer]``, or "control") in the
    place of layer kind ``layer``'s kernel entry."""
    from repro_torch.kernels import kv_shuttle, moe_dispatch
    if layer == "moe":
        orig = moe_dispatch.moe_dispatch_combine
        monkeypatch.setattr(moe_dispatch, "moe_dispatch_combine",
                            _control_moe if what == "control"
                            else _break_moe(what, orig))
    else:
        orig = kv_shuttle.kv_shuttle
        monkeypatch.setattr(kv_shuttle, "kv_shuttle",
                            _control_kv if what == "control"
                            else _break_kv(what, orig))
