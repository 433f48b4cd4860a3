"""Host seconds the traced solve spends building the projected H
(``to_sparse``, symmetrize and shift; ``matrix_elements`` on a dense
basis): the program's ``skqd.project`` span, a ``skqd.run``. None where
the program has no such spans."""


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
    total = snap["spans"].get("skqd.project", {}).get("total_s", 0.0)
    return total / runs
