"""Device-memory-aware sizing of device-resident structures.

Counterpart of ``flow_guided_krylov_tpu/utils/memory.py``: the budget is
the card's total memory from ``torch.cuda.mem_get_info``, or half the host
RAM for the CPU.  The fractions are the JAX package's; they leave room for
temporaries next to the structure being sized.  None of its TPU limits
(per-program caps, worker crash sizes) carries over.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

__all__ = ["device_memory_bytes", "MemoryBudget"]


def device_memory_bytes(device) -> int:
    """Total memory in bytes of ``device`` (a CUDA card or the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    if device.type == "cpu":
        return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
                   * 0.5)
    raise ValueError(f"no memory budget for device {device}")


@dataclass(frozen=True)
class MemoryBudget:
    """Derives capacity knobs from the device memory size."""

    total_bytes: int

    @classmethod
    def for_device(cls, device) -> "MemoryBudget":
        return cls(device_memory_bytes(device))

    def connection_table_entries(self) -> int:
        """Cap for the precomputed all-connections table
        (``utils/connection_table.py``): each entry holds an int32 target
        index + a float32 element (8 B), and building or transposing it
        transiently doubles that.  Budget: 25% of memory."""
        return int(max(1_000_000, min(2_000_000_000,
                                      self.total_bytes * 0.25 / 16)))

    def dense_hamiltonian_cap(self, n_copies: int = 2) -> int:
        """Max subspace dimension whose dense f32 H (plus ``n_copies``-1
        working copies) fits in 25% of memory:
        dim^2 * 4 * n_copies <= 0.25 * total."""
        dim = (self.total_bytes * 0.25 / (4 * max(n_copies, 1))) ** 0.5
        return int(max(4096, min(65536, dim)))

    def pt2_score_rows(self, n_connections: int) -> int:
        """Max source rows per PT2 device-scoring block
        (``krylov/residual_expansion.py``): a block flattens
        rows * n_connections candidates (int64 words and key, f32
        contribution, sort permutation: ~48 B/entry live).  Budget: 40% of
        memory, rounded down to a power of two."""
        entries = self.total_bytes * 0.40 / 48
        rows = int(max(64, entries / max(n_connections, 1)))
        return 1 << (rows.bit_length() - 1)
