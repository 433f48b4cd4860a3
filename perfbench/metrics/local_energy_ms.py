"""Device milliseconds of one stage-1 step's local energies: the kernel
time launched inside the program's ``stage1.local_energy`` span (the
gathers from the connection table, the NQS over every connected row,
the ratios and their sum) over the traced solve's ``stage1.steps``.
None without a card, or where the program has no such span or
counter."""

from perfbench.program_trace import counters


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.kernel_seconds_in("stage1.local_energy")
    steps = counters(ctx).get("stage1.steps")
    if not seconds or not steps:
        return None
    return 1000.0 * seconds / steps
