"""Mean host time of one call of the program's layer (``run``: the
workload build's and the kernel wrapper's Python, up to the launch's
return), on the benchmark's own CPU-clock span around each call."""


def read(ctx):
    ns = ctx.window.host_ns
    return sum(ns) / len(ns) / 1e6
