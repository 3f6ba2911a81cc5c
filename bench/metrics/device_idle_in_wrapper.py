"""Share (%) of the traced window in which the device idled while the host
was inside a kernel wrapper: the idle gaps between the device operations
whose midpoint falls inside one of the program's ``*.call`` spans
(``repro_torch.core.telemetry.spans``, on the profiler's clock), over the
window's wall time. At most ``device_idle``; the rest of that is idle
outside the program. None where the program recorded no such span."""
import bisect


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.trace.spans:
        return None
    try:
        from repro_torch.core.telemetry import spans
    except ImportError:
        return None
    lo = min(s[1] for s in ctx.trace.spans)
    hi = max(s[2] for s in ctx.trace.spans)
    calls = sorted((t0, t1) for name, _, parent, t0, t1 in spans()
                   if parent is None and name.endswith(".call")
                   and lo <= t0 and t1 <= hi)
    if not calls:
        return None
    starts = [t0 for t0, _ in calls]
    idle, end = 0, None
    for _, t, d in sorted(ctx.trace.ops, key=lambda o: o[1]):
        if end is not None and t > end:
            mid = (end + t) // 2
            k = bisect.bisect_right(starts, mid) - 1
            if k >= 0 and mid < calls[k][1]:
                idle += t - end
        end = t + d if end is None else max(end, t + d)
    return 100.0 * idle / 1e9 / ctx.window.wall_s
