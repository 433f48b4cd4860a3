"""Share of the float32 peak of the stage-1 local energies on the
``table`` route: the NQS forward FLOPs over the connected rows (the
program's ``stage1.nqs_rows`` counter times 2 * sum(in * out) of the
NQS's linear layers, from the record's ``nqs_widths``) over the device
time launched inside ``stage1.local_energy``.  The table's gathers, the
ratios and their sum run in that time too and count against the share.
None on another route, without a card, or where the program has no such
span or counter."""

from perfbench.metrics.stage1_mfu_pct import step_flops
from perfbench.peaks import F32_FLOP_PER_S
from perfbench.program_trace import counters


def nqs_row_flops(widths) -> int:
    """Forward FLOPs of one row through the NQS's linear layers: what
    ``stage1_mfu_pct.step_flops`` counts for each connected row."""
    r = {"flow": [], "nqs_widths": list(widths), "batch": 1, "n_valid": 0,
         "route": "table"}
    return step_flops(r, 1) - step_flops(r, 0)


def read(ctx):
    t = ctx.trace
    if t is None or t.record is None:
        return None
    records = list(ctx.records) + [t.record]
    if any(r.get("route") != "table" for r in records):
        return None
    seconds = t.kernel_seconds_in("stage1.local_energy")
    rows = counters(ctx).get("stage1.nqs_rows")
    if not seconds or not rows:
        return None
    flops = rows * nqs_row_flops(t.record["nqs_widths"])
    return 100.0 * flops / seconds / F32_FLOP_PER_S
