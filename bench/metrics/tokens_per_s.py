"""Tokens of every step completed in the window over the window's wall
time (host clock, first enqueue to the final synchronize)."""


def read(ctx):
    tokens = sum(ctx.layer.tokens(j) for j in ctx.window.entries)
    return tokens / ctx.window.wall_s
