"""``kv_shuttle_kernel``'s (csrc/kv_shuttle.cu) share of its roofline
(%): the steps' least times from ``bench/counts/kv.py`` over the kernel's
device time in the traced window."""


def read(ctx):
    return ctx.roofline("kv_shuttle_kernel")
