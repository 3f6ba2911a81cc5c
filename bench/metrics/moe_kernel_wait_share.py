"""Share (%) of ``moe_kernel``'s (csrc/moe_dispatch.cu) CTA cycles, both
roles (routed and second stream) together, spent waiting: thread 0's
cycles in the slow path of a flag spin and in the send window's
bulk-group waits. The kernel counts them with ``clock64`` in each CTA of
one launch in 17 while the profiler records
(``repro_torch.core.telemetry.cycle_share``); None where it counted
nothing."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch.core.telemetry import cycle_share
    except ImportError:
        return None
    return cycle_share("moe_kernel", "wait")
