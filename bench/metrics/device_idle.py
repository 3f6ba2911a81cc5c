"""Share (%) of the traced window in which no operation ran on the
device: one less the union of the device operations' spans over the
window's wall time."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window.wall_s)
