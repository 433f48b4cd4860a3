"""The whole Trotter evolve's FLOPs over the float32 peak (traced runs,
whose evolve spans are synchronized on both sides).

Counted from the Hamiltonian, not from the kernels run: a substep of the
n-site chain applies two diagonal half phases, a complex multiply of
each of the 2^n amplitudes (6 FLOPs), and n single-site X rotations,
each mixing every amplitude with its partner by a real cosine and an
imaginary sine (6 FLOPs an amplitude).
"""

from perfbench.peaks import F32_FLOP_PER_S


def read(ctx):
    if not ctx.on_card or ctx.trace is None:
        return None
    recs = [r for r in ctx.records if r.get("evolve_s")]
    if not recs:
        return None
    n = ctx.cell.n
    per_substep = (1 << n) * (6 * n + 2 * 6)
    flops = sum(r["substeps"] * per_substep for r in recs)
    seconds = sum(sum(r["evolve_s"]) for r in recs)
    return 100.0 * flops / seconds / F32_FLOP_PER_S
