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
from typing import Optional, Sequence

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

    def nqs_chunk_size(self, n_inputs: int,
                       hidden_dims: Optional[Sequence[int]] = None) -> int:
        """Rows per chunk of gradient-free NQS evaluation over connection
        batches: a chunk keeps (inputs + activations) f32 live per row.
        Budget: 10% of memory; clamped to [4096, 131072] and rounded to a
        multiple of 1024."""
        width = n_inputs + sum(hidden_dims or [256] * 4)
        rows = self.total_bytes * 0.10 / (4 * max(width, 1))
        rows = max(4096, min(131072, int(rows)))
        return (rows // 1024) * 1024

    def dense_hamiltonian_cap(self, n_copies: int = 2) -> int:
        """Max subspace dimension whose dense f32 H (plus ``n_copies``-1
        working copies) fits in 25% of memory:
        dim^2 * 4 * n_copies <= 0.25 * total."""
        dim = (self.total_bytes * 0.25 / (4 * max(n_copies, 1))) ** 0.5
        return int(max(4096, min(65536, dim)))

    # live bytes a PT2 candidate at 4 words a row: the four int64 target
    # words (32), the (alpha, beta) key pair and its sorted copy (32), two
    # stable sorts' permutations and scratch (24), the f32 element,
    # contribution and score (12), flags and segment starts (~8); counted
    # up to 128
    PT2_BYTES_PER_ENTRY_W4 = 128

    def pt2_score_rows(self, n_connections: int, row_words: int = 2) -> int:
        """Max source rows per PT2 device-scoring block
        (``krylov/residual_expansion.py``): a block flattens
        rows * n_connections candidates (at 1 or 2 words a row: int64
        words and key, f32 contribution, sort permutation, ~48 B/entry
        live; at 4 words ``PT2_BYTES_PER_ENTRY_W4``).  Budget: 40% of
        memory, rounded down to a power of two."""
        per_entry = 48 if row_words <= 2 else self.PT2_BYTES_PER_ENTRY_W4
        entries = self.total_bytes * 0.40 / per_entry
        rows = int(max(64, entries / max(n_connections, 1)))
        return 1 << (rows.bit_length() - 1)

    def lanczos_ell_m(self, n_states: int, n_connections: int,
                      m_max: int = 120) -> int:
        """Max Lanczos depth of the fully reorthogonalized device ELL
        eigensolver (``postprocessing/eigensolver.py``): the (m, N) float32
        Krylov block is the largest allocation beside the two (C, N)
        tables (float32 + int32, 8 B an entry) and a few N-vector
        temporaries.  The block gets 40% of memory less the tables and
        eight N-vectors.

        The JAX package also padded the tables by 1.3 (TPU sublanes),
        clamped the block to 1 GB and floored the depth at 4, all three
        for limits of its TPU worker.  Here the tables are counted at
        their size, the block is bounded by the 40% rule alone, and the
        floor is 2, the shortest recurrence that can improve a start
        vector; depth past the block comes from restarts."""
        tables = 2 * n_connections * n_states * 4
        scratch = 8 * n_states * 4
        block = self.total_bytes * 0.40 - tables - scratch
        m = int(block / (max(n_states, 1) * 4))
        return max(2, min(m_max, m))

    # a chunk's connection holds int64 words, key and search position, the
    # float32 element, the int32 target and their transposed copies live
    # at once; counted generously
    BUILD_BYTES_PER_ENTRY = 96
    BUILD_MAX_ROWS = 1 << 19

    def build_chunk_rows(self, n_connections: int) -> int:
        """Rows per chunk of a device ELL table build
        (``krylov/skqd.py::_build_ell_device``): a chunk keeps
        rows * n_connections connections of ``BUILD_BYTES_PER_ENTRY`` bytes
        live.  Budget: 10% of memory, beside the finished (C, N) tables; at
        most ``BUILD_MAX_ROWS``, at least 64."""
        rows = self.total_bytes * 0.10 / (self.BUILD_BYTES_PER_ENTRY
                                          * max(n_connections, 1))
        return int(max(64, min(self.BUILD_MAX_ROWS, rows)))

    def statevector_sites_cap(self) -> int:
        """Max spin count for the full 2^n statevector Trotter propagator:
        a substep keeps about 4 (re, im) float32 vector pairs live, so
        2^n * 8 * 4 <= 50% of memory; between 16 and 28 sites."""
        import math
        n = math.log2(max(self.total_bytes * 0.50 / 32, 2))
        return int(max(16, min(28, n)))
