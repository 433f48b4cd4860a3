"""Milliseconds a stage-3 round takes to score its external candidates:
the program's ``sci.score`` span (connections of the significant
sources, the keyed sum of couplings, the PT2 denominators; on the host,
or on the device past ``DEVICE_SCORING_MIN_ELEMS``; it ends in host
reads), mean over the traced solve's ``sci.rounds``.  The program's
``sci.device_rounds`` says how many took the device block.  None where
the program has no such span or counter."""

from perfbench.program_trace import counters, span_ms


def read(ctx):
    if not counters(ctx).get("sci.rounds"):
        return None
    return span_ms(ctx, "sci.score")
