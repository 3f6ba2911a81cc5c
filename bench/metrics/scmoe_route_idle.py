"""Share (%) of the traced window in which the device idled while the host
routed a ScMoE layer: the idle gaps between the device operations whose
midpoint falls from the start of one of the program's ``scmoe.route``
spans (the router, the picks, the table of rows per pair and its read on
the host; ``repro_torch.core.telemetry.spans``, on the profiler's clock)
to the start of the first ``moe_kernel`` after that span. The table's
read waits for the device, so the device idles from then until the
layer's kernel starts, also while the host is inside ``moe_dispatch.call``
(its prepare, alloc and launch): that idle is the route's, and is also
part of ``device_idle_in_wrapper``. Over the window's wall time. None
where the program recorded no such span."""
import bisect

from bench.lib.trace import kernel_pattern

KERNEL = kernel_pattern("moe_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.trace.spans:
        return None
    try:
        from repro_torch.core.telemetry import spans
    except ImportError:
        return None
    lo = min(s[1] for s in ctx.trace.spans)
    hi = max(s[2] for s in ctx.trace.spans)
    route = sorted((t0, t1) for name, _, _, t0, t1 in spans()
                   if name == "scmoe.route" and lo <= t0 and t1 <= hi)
    if not route:
        return None
    ops = sorted(ctx.trace.ops, key=lambda o: o[1])
    kernels = [t for name, t, _ in ops if KERNEL.search(name)]
    starts, ends = [], []
    for t0, t1 in route:
        k = bisect.bisect_left(kernels, t1)
        starts.append(t0)
        ends.append(max(t1, kernels[k]) if k < len(kernels) else t1)
    idle, end = 0, None
    for _, t, d in ops:
        if end is not None and t > end:
            mid = (end + t) // 2
            k = bisect.bisect_right(starts, mid) - 1
            if k >= 0 and mid < ends[k]:
                idle += t - end
        end = t + d if end is None else max(end, t + d)
    return 100.0 * idle / 1e9 / ctx.window.wall_s
