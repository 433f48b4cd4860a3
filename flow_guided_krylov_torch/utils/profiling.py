"""The port's tracer: named spans and counters on the profiler's clock,
the per-stage wall-clock timer, a profiler trace and device memory stats.

Counterpart of ``flow_guided_krylov_tpu/utils/profiling.py``:
:class:`StageTimer`, which the pipeline and the smoke run share;
:func:`trace`, a ``torch.profiler`` trace written as a Chrome trace; and
:func:`device_memory_stats`, the JAX function's keys from
``torch.cuda.memory_stats``.  The JAX module's compilation-cache and
platform workarounds have nothing to work around here and are not
carried.

Recording is on only while a ``torch.profiler`` session runs (for one,
:func:`trace`).  Then :func:`span` opens a ``record_function`` range, so
the span sits in the profiler's trace beside the kernels it launched,
and keeps its name, start, end, enclosing span and root in memory;
:func:`count` adds to a named counter; :func:`snapshot` sums both.  With
recording off a span is one flag check: it opens no range, does not
synchronize and records nothing.  Spans and counters are kept for one
thread's work, in the process's one record (:func:`reset` clears it).

``StageTimer`` keeps its host-clock totals whether or not recording is
on; each of its spans is also a :func:`span` that synchronizes.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

__all__ = ["StageTimer", "trace", "device_memory_stats", "recording",
           "span", "count", "counted_eigsh", "snapshot", "records",
           "reset", "SpanRecord"]

_profiler_enabled = torch._C._autograd._profiler_enabled


def recording() -> bool:
    """True while a ``torch.profiler`` session runs."""
    return _profiler_enabled()


@dataclass
class SpanRecord:
    """One span: ``perf_counter_ns`` times (``end_ns`` None while open),
    the enclosing span's ``id`` (None for a root) and the root's."""
    id: int
    name: str
    start_ns: int
    parent: Optional[int]
    root: int
    end_ns: Optional[int] = None


_ids = itertools.count()
_spans: List[SpanRecord] = []
_open: List[SpanRecord] = []
_counters: Dict[str, float] = {}


@contextlib.contextmanager
def span(name: str, sync: bool = False):
    """A named range of the program.  With ``sync`` it synchronizes the
    card before it closes, so it covers the device work it started."""
    if not recording():
        yield
        return
    parent = _open[-1] if _open else None
    rid = next(_ids)
    rec = SpanRecord(rid, name, 0, parent.id if parent else None,
                     parent.root if parent else rid)
    _spans.append(rec)
    _open.append(rec)
    with torch.profiler.record_function(name):
        rec.start_ns = time.perf_counter_ns()
        try:
            yield
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            rec.end_ns = time.perf_counter_ns()
            _open.remove(rec)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (while recording)."""
    if recording():
        _counters[name] = _counters.get(name, 0) + n


def counted_eigsh(M, **kw):
    """SciPy's ``eigsh(M, **kw)`` in an ``eigsh`` span.  While recording
    it gets a ``LinearOperator`` that applies ``M`` as ``eigsh`` itself
    would and counts ``eigsh.matvecs`` and their host seconds,
    ``eigsh.matvec_s``: the same arithmetic, so the same iterations and
    answer; ``eigsh.pairs`` sums the eigenpairs asked for (``k``).
    Otherwise it gets ``M`` itself."""
    import scipy.sparse.linalg as spla
    count("eigsh.pairs", kw.get("k", 6))
    with span("eigsh"):
        if not recording():
            return spla.eigsh(M, **kw)
        apply = spla.aslinearoperator(M).matvec
        calls, ns = 0, 0

        def matvec(x):
            nonlocal calls, ns
            t0 = time.perf_counter_ns()
            y = apply(x)
            ns += time.perf_counter_ns() - t0
            calls += 1
            return y

        op = spla.LinearOperator(M.shape, matvec=matvec, dtype=M.dtype)
        try:
            return spla.eigsh(op, **kw)
        finally:
            count("eigsh.matvecs", calls)
            count("eigsh.matvec_s", ns * 1e-9)


def records() -> List[SpanRecord]:
    """The recorded spans, in the order they opened."""
    return list(_spans)


def snapshot() -> Dict[str, Dict]:
    """``{"spans": {name: {calls, total_s, self_s}}, "counters": {...}}``
    over the closed spans; ``self_s`` is ``total_s`` less the part the
    span's own child spans cover."""
    closed = [r for r in _spans if r.end_ns is not None]
    child_ns: Dict[int, int] = {}
    for r in closed:
        if r.parent is not None:
            child_ns[r.parent] = (child_ns.get(r.parent, 0)
                                  + r.end_ns - r.start_ns)
    out: Dict[str, Dict] = {}
    for r in closed:
        s = out.setdefault(r.name, {"calls": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        total = r.end_ns - r.start_ns
        s["calls"] += 1
        s["total_s"] += total * 1e-9
        s["self_s"] += (total - child_ns.get(r.id, 0)) * 1e-9
    return {"spans": out, "counters": dict(_counters)}


def reset() -> None:
    """Clear the recorded spans and counters."""
    _spans.clear()
    _counters.clear()


class StageTimer:
    """Accumulates named wall-clock spans; ``.summary()`` is JSON-friendly."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name, sync=True):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": round(self.spans[name], 4),
                       "calls": self.counts[name],
                       "mean_s": round(self.spans[name]
                                       / max(1, self.counts[name]), 4)}
                for name in self.spans}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host, and the card where there is one) and
    write ``trace.json`` (Chrome trace format, ``chrome://tracing`` or
    Perfetto) into ``log_dir``, and beside it ``spans.json``, the
    :func:`snapshot` of the block's spans and counters.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(snapshot(), f, indent=2)


def device_memory_stats() -> Optional[Dict]:
    """{``cuda:i``: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for
    every card PyTorch sees (allocator bytes; the limit is the card's
    memory), or None without a card."""
    if not torch.cuda.is_available():
        return None
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
