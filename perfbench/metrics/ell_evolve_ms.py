"""Milliseconds an ELL Lanczos evolve of the traced solve takes
(synchronized, the host vector in and out): the program's
``skqd.evolve`` spans, their own time (the table build, a child span of
the first, left out), mean over the evolves.  None where the program has
no such span."""

from perfbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "skqd.evolve", own=True)
