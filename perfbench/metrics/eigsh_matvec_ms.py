"""Host milliseconds an ARPACK operator application takes in the traced
solve: the program's ``eigsh.matvec_s`` over ``eigsh.matvecs``
(``utils/profiling.py``).  None where the solve ran no ``eigsh`` (a
basis of 2048 states or fewer goes to a dense ``eigh``) or the program
has no such counters."""


def _snapshot():
    """The program tracer's snapshot, or None where the program has
    no tracer."""
    try:
        from flow_guided_krylov_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def _solves(ctx):
    """The snapshot and its count of ``skqd.run`` spans, or (None, 0)."""
    snap = _snapshot() if ctx.trace is not None else None
    if snap is None:
        return None, 0
    return snap, snap["spans"].get("skqd.run", {}).get("calls", 0)


def read(ctx):
    snap, runs = _solves(ctx)
    if not runs:
        return None
    c = snap["counters"]
    calls = c.get("eigsh.matvecs", 0)
    return 1000.0 * c.get("eigsh.matvec_s", 0.0) / calls if calls else None
