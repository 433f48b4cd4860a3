"""The benchmark's spans, its host-eigensolve timer and its reading of a
``torch.profiler`` trace.

Spans are ``torch.profiler.record_function`` ranges that the benchmark's
own files open around calls into the program; outside a profiled solve
they only cost a function call.  :func:`traced_solve` profiles one solve
(host and device activity) and keeps only the sums the metrics read:
kernel time by name, the device's busy time, the idle gaps named by the
innermost span open at the time, and kernel time by the span that
launched it.  No trace file is written.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple
from unittest import mock

import numpy as np
import scipy.sparse.linalg

__all__ = ["HostEigensolves", "span", "traced_solve", "TraceSummary"]

NAME_CHARS = 120     # a kernel's name in the breakdown, cut to this length


@contextlib.contextmanager
def span(name: str):
    from torch.profiler import record_function
    with record_function(name):
        yield


class HostEigensolves:
    """Wall seconds the block spends in host eigensolvers: SciPy's
    ``eigsh``, NumPy's ``eigh`` / ``eigvalsh`` and the program's
    ``DavidsonSolver.solve``, the outermost call counted once."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._depth = 0

    def _wrap(self, fn):
        timer = self

        def timed(*args, **kw):
            timer._depth += 1
            t0 = time.perf_counter()
            try:
                if timer._depth > 1:
                    return fn(*args, **kw)
                with span("host_eigensolve"):
                    return fn(*args, **kw)
            finally:
                timer._depth -= 1
                if timer._depth == 0:
                    timer.seconds += time.perf_counter() - t0
                    timer.calls += 1
        return timed

    @contextlib.contextmanager
    def patched(self):
        from flow_guided_krylov_torch.postprocessing import eigensolver
        dav = eigensolver.DavidsonSolver.solve
        with mock.patch.object(scipy.sparse.linalg, "eigsh",
                               self._wrap(scipy.sparse.linalg.eigsh)), \
                mock.patch.object(np.linalg, "eigh",
                                  self._wrap(np.linalg.eigh)), \
                mock.patch.object(np.linalg, "eigvalsh",
                                  self._wrap(np.linalg.eigvalsh)), \
                mock.patch.object(eigensolver.DavidsonSolver, "solve",
                                  self._wrap(dav)):
            yield self


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _inside(spans: Dict[str, np.ndarray], t: np.ndarray):
    """For each span name, which of the times ``t`` fall in one of its
    ranges (a name's ranges never overlap), and that range's width."""
    for name, (s0, s1) in spans.items():
        i = np.searchsorted(s0, t, "right") - 1
        ok = i >= 0
        ok[ok] &= t[ok] <= s1[i[ok]]
        width = np.where(ok, s1[np.maximum(i, 0)] - s0[np.maximum(i, 0)],
                         0)
        yield name, ok, width


class TraceSummary:
    """Sums read from one profiled solve (nanoseconds kept internally)."""

    def __init__(self, events, t0_ns: int, t1_ns: int, wall_s: float):
        self.window_s = wall_s
        launches: Dict[int, int] = {}
        ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        device: List[Tuple[int, int, str, int]] = []
        for e in events:
            if "CUDA" in str(e.device_type()):
                if not e.is_user_annotation():
                    device.append((e.start_ns(),
                                   e.start_ns() + e.duration_ns(),
                                   e.name(), e.correlation_id()))
            elif e.is_user_annotation():
                ranges[e.name()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
            elif e.correlation_id():
                launches[e.correlation_id()] = e.start_ns()
        spans = {k: tuple(np.array(x, np.int64) for x in zip(*sorted(v)))
                 for k, v in ranges.items()}
        busy = _union([(a, b) for a, b, _, _ in device])
        self.busy_s = sum(b - a for a, b in busy) * 1e-9
        self.kernel_ns: Dict[str, int] = defaultdict(int)
        for a, b, name, _ in device:
            self.kernel_ns[name] += b - a
        # kernel time by each span open when the kernel was launched
        dur = np.array([b - a for a, b, _, _ in device], np.int64)
        t = np.array([launches.get(c, -1) for _, _, _, c in device],
                     np.int64)
        self.kernels_by_span_ns = {name: int(dur[ok].sum())
                                   for name, ok, _ in _inside(spans, t)}
        # idle gaps over the solve, named by the innermost span open at
        # each gap's middle
        edges = np.array([t0_ns] + [x for ab in busy for x in ab] + [t1_ns],
                         np.int64)
        a, b = edges[0::2], edges[1::2]
        keep = b > a
        a, b = a[keep], b[keep]
        mid = (a + b) // 2
        label = np.full(len(mid), "outside any span", dtype=object)
        best = np.full(len(mid), np.iinfo(np.int64).max)
        for name, ok, width in _inside(spans, mid):
            take = ok & (width < best)
            label[take] = name
            best[take] = width[take]
        self.idle_ns: Dict[str, int] = defaultdict(int)
        for name, gap in zip(label, b - a):
            self.idle_ns[name] += int(gap)

    def kernel_seconds_in(self, span_name: str) -> Optional[float]:
        ns = self.kernels_by_span_ns.get(span_name)
        return None if not ns else ns * 1e-9

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_ns.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_ns.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:NAME_CHARS], v * 1e-9] for k, v in ops],
                "idle_gaps": [[k, v * 1e-9] for k, v in gaps]}


def traced_solve(cell, seed: int, on_card: bool) -> TraceSummary:
    """One more solve of ``cell`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with span("solve"):
            record = cell.solve(seed, traced=True)
            if on_card:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    solve = [e for e in events if e.is_user_annotation()
             and e.name() == "solve" and "CUDA" not in str(e.device_type())]
    t0_ns = solve[0].start_ns()
    t1_ns = t0_ns + solve[0].duration_ns()
    summary = TraceSummary(events, t0_ns, t1_ns, wall)
    summary.record = record
    return summary
