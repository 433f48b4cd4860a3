"""The program's own spans and counters (``flow_guided_krylov_torch/
utils/profiling.py``) as the per-layer metrics read them, and the bytes
the ELL kernel's launches must move.

The program records only under the profiler, so after a ``--trace 1``
run its snapshot holds the traced solve alone.  Every reader returns
None where the program has no tracer, or no such span or counter (an
older program), and never raises.
"""

from __future__ import annotations

from typing import Optional

ELL_KERNEL = "ell_spmv_kernel"       # the kernel's name in the device trace


def snapshot(ctx) -> Optional[dict]:
    """The program tracer's snapshot after a traced run, else None."""
    if ctx.trace is None:
        return None
    try:
        from flow_guided_krylov_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def span_ms(ctx, name: str, own: bool = False) -> Optional[float]:
    """Milliseconds a call of the span ``name`` (its own time, less its
    child spans, with ``own``), mean over its calls in the traced solve."""
    snap = snapshot(ctx)
    s = snap["spans"].get(name) if snap else None
    if not s or not s["calls"]:
        return None
    return 1000.0 * s["self_s" if own else "total_s"] / s["calls"]


def counters(ctx) -> dict:
    snap = snapshot(ctx)
    return snap["counters"] if snap else {}


def ell_bytes(c: dict) -> Optional[float]:
    """Bytes the traced solve's ELL launches must move, from the
    program's counters: each launch reads the (C, N) float32 elements and
    int32 targets once (C N 4 bytes each) and the float32 diagonal (N 4),
    and reads and writes its B float32 vectors of N (B N 4 each way).  C
    is ``ell.entries`` / ``ell.rows``, N ``ell.rows`` (the traced solve
    builds one table)."""
    launches, rows = c.get("ell.launches"), c.get("ell.rows")
    entries, vectors = c.get("ell.entries"), c.get("ell.vectors")
    if not (launches and rows and entries and vectors):
        return None
    C = entries / rows
    return launches * (2 * C * rows * 4 + rows * 4) + vectors * rows * 4 * 2
