"""The whole step's share (%) of the card's peak: the useful FLOPs of
every step in the window (``bench/counts/``) over the window's wall time
times the peak of the configuration's precision (``counts/peaks.py``)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    flops = sum(ctx.layer.flops(j) for j in ctx.window.entries)
    return 100.0 * flops / (ctx.window.wall_s * ctx.flops_peak())
