"""Seconds a solve: the whole window over the solves it completed."""


def read(ctx):
    if not ctx.records:
        return None
    return ctx.window_s / len(ctx.records)
