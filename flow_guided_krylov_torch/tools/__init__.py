"""The port's measurement tools, each run on the card as

    python -m flow_guided_krylov_torch.tools.<name> [--device cuda]

* ``roofline_connection`` — the connection function's roofline from its
  output tensors, and (``--measure``) the device time, launches and share
  of the wall of its ablated variants;
* ``repro_pt2_block`` — one production-scale PT2 scoring block
  (``SelectedCIExpander._pt2_topk_device``), and (``--sweep``) the device
  block against the host path over five source sizes;
* ``sharded_scaling`` — the sharded Trotter evolve and ELL matvec of
  ``parallel/`` on meshes of 1, 2 and 4 entries;
* ``ccsd_bar`` — a host CCSD(T) oracle of a registered system.

A device tool prints the card's ``nvidia-smi`` name and power limit
first and times with CUDA events.  Given a CPU device (the tests do) it
computes the same work and reports no time: every timing field is None,
since a CPU time is no figure of the card.  The H100's published peaks
are here, and ``chip_smoke.py`` reads them from here.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12            # float32 outside the tensor cores

__all__ = ["HBM_BYTES_PER_S", "F32_FLOP_PER_S", "bound", "card",
           "time_ms", "profile_launches", "system", "random_determinants"]


def bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """Least time in ms for the bytes at the memory's rate and the flops
    at the float32 rate, and which of the two sets it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def system(name: str, device):
    """A registered large system (``examples/large_system_benchmark``) or
    a benchmark molecule (``hamiltonians.MOLECULE_FACTORIES``) on
    ``device``."""
    from ..examples.large_system_benchmark import SYSTEMS
    from ..hamiltonians import MOLECULE_FACTORIES
    if name in SYSTEMS:
        return SYSTEMS[name](device)
    if name in MOLECULE_FACTORIES:
        return MOLECULE_FACTORIES[name](device)
    raise KeyError(f"{name}: neither a registered system "
                   f"({sorted(SYSTEMS)}) nor a molecule "
                   f"({sorted(MOLECULE_FACTORIES)})")


def random_determinants(h, count: int, seed: int = 0) -> np.ndarray:
    """``count`` distinct particle-conserving determinants of ``h``, drawn
    uniformly from ``seed``, as (count, W) uint32 rows."""
    import numpy as np
    from ..ops.bits import pack2_np, pack_np
    if count > h.n_valid_configs:
        raise ValueError(f"{count} distinct determinants asked of a space "
                         f"of {h.n_valid_configs}")
    rng = np.random.default_rng(seed)
    n = h.n_orbitals
    rows, seen = [], set()
    while len(rows) < count:
        occ = np.zeros((count, 2, n), np.int64)
        for s, k in enumerate((h.n_alpha, h.n_beta)):
            pick = np.argsort(rng.random((count, n)), axis=1)[:, :k]
            np.put_along_axis(occ[:, s], pick, 1, axis=1)
        if h.pack_words == 4:
            packed = np.concatenate([pack2_np(occ[:, 0]),
                                     pack2_np(occ[:, 1])], -1)
        else:
            packed = pack_np(occ.reshape(count, 2 * n), n)
        for row in packed:
            key = row.tobytes()
            if key not in seen and len(rows) < count:
                seen.add(key)
                rows.append(row)
    return np.stack(rows)


def card(device) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card a CUDA
    ``device`` names, None for another device."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(index)],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def time_ms(fn: Callable[[], object], device, reps: int = 5,
            inner: int = 1) -> Optional[float]:
    """Median over ``reps`` warm windows, each timed with CUDA events, of
    the ms per call of ``inner`` back-to-back calls of ``fn`` on a CUDA
    ``device``; None on another device (after one call, so the work is
    still done)."""
    import torch
    device = torch.device(device)
    fn()
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profile_launches(fn: Callable[[], object], device
                     ) -> Tuple[Optional[int], Optional[float]]:
    """(kernel launches, summed kernel ms) of one warm call of ``fn``
    under ``torch.profiler`` on a CUDA ``device``; (None, None) on
    another device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if torch.device(device).type != "cuda":
        return None, None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, dev_us = 0, 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches += ev.count
            dev_us += ev.device_time_total
    return launches, dev_us / 1e3
