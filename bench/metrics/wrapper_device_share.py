"""Device time (%) of the operations other than the layer's main kernel
(the wrappers' fills, copies and adds) over all device time in the
traced window."""


def read(ctx):
    if ctx.trace is None:
        return None
    total = ctx.trace.device_ns()
    if not total:
        return None
    main, _ = ctx.trace.kernel_ns(ctx.layer.kernel)
    return 100.0 * (total - main) / total
