"""Per-stage wall-clock timer, a profiler trace and device memory stats.

Counterpart of ``flow_guided_krylov_tpu/utils/profiling.py``:
:class:`StageTimer`, which the pipeline and the smoke run share;
:func:`trace`, a ``torch.profiler`` trace written as a Chrome trace; and
:func:`device_memory_stats`, the JAX function's keys from
``torch.cuda.memory_stats``.  The JAX module's compilation-cache and
platform workarounds have nothing to work around here and are not
carried.

``StageTimer`` is host clock only: a span around device work includes the
device time only where the work ends in a synchronizing read.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

__all__ = ["StageTimer", "trace", "device_memory_stats"]


class StageTimer:
    """Accumulates named wall-clock spans; ``.summary()`` is JSON-friendly."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
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

    def dump(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host, and the card where there is one) and
    write ``trace.json`` (Chrome trace format, ``chrome://tracing`` or
    Perfetto) into ``log_dir``.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Optional[Dict]:
    """{``cuda:i``: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for
    every card PyTorch sees (allocator bytes; the limit is the card's
    memory), or None without a card."""
    import torch
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
