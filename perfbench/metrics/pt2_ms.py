"""Milliseconds the traced solve takes for the exact Epstein-Nesbet dE2
of its SCI state (device or host route): the program's ``residual.pt2``
span.  None where the program has no such span."""

from perfbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "residual.pt2")
