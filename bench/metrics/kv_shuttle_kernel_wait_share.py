"""Share (%) of ``kv_shuttle_kernel``'s (csrc/kv_shuttle.cu) CTA cycles,
both roles (prefill CTAs and the decode CTA) together, spent waiting:
thread 0's cycles in the slow path of a flag spin and in the send
window's bulk-group waits, and the decode warp's receive waits. The
kernel counts them with ``clock64`` in each CTA of one launch in 17
while the profiler records (``repro_torch.core.telemetry.cycle_share``);
None where it counted nothing."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch.core.telemetry import cycle_share
    except ImportError:
        return None
    return cycle_share("kv_shuttle_kernel", "wait")
