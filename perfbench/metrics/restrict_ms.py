"""Milliseconds the traced solve takes to build its restricted subspace
(the SCI basis diagonalized, its externals PT2-ranked, the top ones up to
the cap kept): the program's ``skqd.restrict`` span.  None where the
program has no such span."""

from perfbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "skqd.restrict")
