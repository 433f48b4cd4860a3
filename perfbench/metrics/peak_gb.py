"""The allocator's peak over the window, in 10^9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
