"""Milliseconds the traced solve takes to build stage 1's device
connection table (every determinant's connections, their key search and
the (N, C) target and element writes; synchronized): the program's
``stage1.table_build`` span.  None where the program has no such span."""

from perfbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "stage1.table_build")
