"""Share of the HBM bound of the traced solve's Trotter substeps: each
substep reads and writes the float32 (re, im) state once, 2^n * 8 bytes
each way, whatever the launches; divided by the device time of every
operation launched inside the evolves."""

from perfbench.peaks import HBM_BYTES_PER_S


def read(ctx):
    t = ctx.trace
    if t is None or t.record is None or "substeps" not in t.record:
        return None
    seconds = t.kernel_seconds_in("evolve")
    if not seconds:
        return None
    n = ctx.cell.n
    moved = t.record["substeps"] * 2 * (1 << n) * 8
    return 100.0 * moved / HBM_BYTES_PER_S / seconds
