"""Tokens the host received before the window closed (first tokens
included: one a call), over the window's length."""


def read(ctx):
    n = sum(1 for c in ctx.calls if c["t_done_s"] <= ctx.window_s)
    return n / ctx.window_s if n else None
