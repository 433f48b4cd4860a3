"""Share of the HBM bound of the traced solve's ELL launches: the bytes
they must move (``program_trace.ell_bytes``, from the program's
``ell.*`` counters) over the device time of the ELL kernel's own
launches, at the card's published bandwidth.  None without the counters
(an older program) or without the kernel in the trace (the CPU)."""

from perfbench.peaks import HBM_BYTES_PER_S
from perfbench.program_trace import ELL_KERNEL, counters, ell_bytes


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    moved = ell_bytes(counters(ctx))
    ns = sum(v for k, v in t.kernel_ns.items() if ELL_KERNEL in k)
    if moved is None or not ns:
        return None
    return 100.0 * moved / HBM_BYTES_PER_S / (ns * 1e-9)
