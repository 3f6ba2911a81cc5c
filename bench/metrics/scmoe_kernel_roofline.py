"""``moe_kernel``'s (csrc/moe_dispatch.cu) share of its roofline (%) in a
ScMoE step: the least time of the kernel's part of each step (the layer's
``kernel_flops`` and ``kernel_nbytes``, ``bench/counts/scmoe.py``: the
routed rows and FFN1, its second stream) over the kernel's device time in
the traced window. None without a trace, for a layer that states no
kernel part, or unless the trace holds as many launches as the steps make
(``Context.launches``)."""
from bench.counts import peaks


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.layer, "kernel_flops"):
        return None
    ns, launches = ctx.trace.kernel_ns(ctx.layer.kernel)
    if not ns or launches != ctx.launches():
        return None
    bound = sum(peaks.bound_s(ctx.layer.kernel_flops(j),
                              ctx.layer.kernel_nbytes(j), ctx.layer.dtype)
                for j in ctx.window.entries)
    return 100.0 * bound / (ns / 1e9)
