"""Mean, over the window's solves, of the energy above the exact one."""


def read(ctx):
    exact = getattr(ctx.cell, "exact", None)
    if exact is None or not ctx.records:
        return None
    return 1000.0 * sum(r["energy"] - exact
                        for r in ctx.records) / len(ctx.records)
