"""Seconds from the process's first statement to the first timed step:
imports, CUDA start, kernel build or load, weights and pool, warm-up."""


def read(ctx):
    return ctx.setup_s
