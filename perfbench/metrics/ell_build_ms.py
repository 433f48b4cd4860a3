"""Milliseconds the traced solve takes to build its ELL tables on the
device (connections, key search, the transposed (C, N) writes;
synchronized): the program's ``skqd.ell_build`` span.  None where the
program has no such span."""

from perfbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "skqd.ell_build")
