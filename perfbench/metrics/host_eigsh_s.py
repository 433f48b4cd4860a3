"""Seconds a solve spends in host eigensolvers (SciPy ``eigsh``, NumPy
``eigh``, the program's Davidson), outermost calls only."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["host_eigensolve_s"] for r in ctx.records) / len(ctx.records)
