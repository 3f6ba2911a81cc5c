"""Mean host time (ms) of the program's kernel wrappers a step, from the
program's own spans (``repro_torch.core.telemetry.spans``, on while the
profiler records): per step, the summed durations of its outermost
``*.call`` spans (``moe_dispatch.call``, ``kv_shuttle.call``) and
``serving.shared_add`` that lie in the traced window. None unless the
window holds one ``*.call`` span for each launch of the layer's kernel
(``Context.launches``: one a step unless the layer states more): a
program without the spans, or a run on the CPU, where the wrappers launch
nothing, reads None."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans:
        return None
    try:
        from repro_torch.core.telemetry import spans
    except ImportError:
        return None
    lo = min(s[1] for s in ctx.trace.spans)
    hi = max(s[2] for s in ctx.trace.spans)
    mine = [(name, t1 - t0) for name, _, parent, t0, t1 in spans()
            if parent is None and lo <= t0 and t1 <= hi
            and (name.endswith(".call") or name == "serving.shared_add")]
    if sum(name.endswith(".call") for name, _ in mine) != ctx.launches():
        return None
    return sum(ns for _, ns in mine) / len(ctx.window.entries) / 1e6
