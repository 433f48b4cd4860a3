"""Milliseconds a Krylov draw of the traced solve takes (uniforms, the
cdf, ``searchsorted``, ``unique`` and the host lists), not
synchronized: the program's ``skqd.sample`` spans, total over calls.
None where the program has no such spans."""


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
    draws = snap["spans"].get("skqd.sample") if runs else None
    if not draws or not draws["calls"]:
        return None
    return 1000.0 * draws["total_s"] / draws["calls"]
