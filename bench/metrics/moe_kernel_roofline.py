"""``moe_kernel``'s (csrc/moe_dispatch.cu) share of its roofline (%):
the steps' least times from ``bench/counts/moe.py`` over the kernel's
device time in the traced window."""


def read(ctx):
    return ctx.roofline("moe_kernel")
