"""Milliseconds a Krylov evolve, synchronized on both sides (traced runs
only), summed over the window and divided by their count."""


def read(ctx):
    times = [t for r in ctx.records for t in r.get("evolve_s", ())]
    return 1000.0 * sum(times) / len(times) if times else None
