"""Device-resident full connection table.

Counterpart of ``flow_guided_krylov_tpu/utils/connection_table.py``.  The
Hamiltonian is fixed and the particle-conserving space enumerable, so all
connections (target indices + matrix elements + diagonal) are computed
once on the Hamiltonian's device.  It is the source of SKQD's full-space
ELL tables; for N2/STO-3G it holds 14,400 x 609 entries (~70 MB).

Targets are found by ``searchsorted`` over int64 keys (``ops/bits.py``),
so any n_orb <= 32 is supported, where the JAX package's uint32 keys
stopped at n_orb = 16.  The table also holds every determinant's
occupations (``occ``), which stage 1's local energies gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.bits import keys_device, to_device, unpack_device

__all__ = ["DeviceConnectionTable", "build_connection_table"]


class DeviceConnectionTable:
    """All-pairs connection data for a particle-conserving space."""

    def __init__(self, basis_packed: np.ndarray, keys_sorted: torch.Tensor,
                 order: torch.Tensor, target_idx: torch.Tensor,
                 elems: torch.Tensor, diag: torch.Tensor,
                 occ: torch.Tensor):
        self.basis_packed = basis_packed        # (N, 2) uint32, host
        self._keys_sorted = keys_sorted         # (N,) int64, device
        self._order = order                     # (N,) int64, device
        self.target_idx = target_idx            # (N, C) int32, device
        self.elems = elems                      # (N, C) f32, device
        self.diag = diag                        # (N,) f32, device
        self.occ = occ                          # (N, 2*n_orb) f32, device

    @property
    def n_configs(self) -> int:
        return self.target_idx.shape[0]

    @property
    def n_connections(self) -> int:
        return self.target_idx.shape[1]

    def key_of(self, packed: torch.Tensor) -> torch.Tensor:
        """(..., 2) int64 words -> (...) int64 key that :meth:`lookup`
        searches, in the (alpha, beta) lexicographic order of the JAX
        table's uint32 key (which stops at 16 orbitals)."""
        return keys_device(packed)

    def lookup(self, packed: torch.Tensor) -> torch.Tensor:
        """(..., 2) int64 words -> (...) int64 indices into the
        enumerated basis (members of the space only)."""
        pos = torch.searchsorted(self._keys_sorted, self.key_of(packed))
        return self._order[pos.clamp_(0, self.n_configs - 1)]

    def local_energy_inputs(self, packed: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """(B, 2) int64 words -> (diag (B,), elems (B, C), target
        occupations (B, C, 2n))."""
        idx = self.lookup(packed)
        return self.diag[idx], self.elems[idx], self.occ[self.target_idx[idx]]


def build_connection_table(hamiltonian, max_entries: int = 50_000_000,
                           chunk: int = 2048
                           ) -> Optional[DeviceConnectionTable]:
    """Build the table on ``hamiltonian.device``, or None when it would
    hold more than ``max_entries`` connections or the determinants take
    four words."""
    if hamiltonian.pack_words > 2:
        # 4-word determinants (more than 32 orbitals): no single int64 key,
        # and no enumerable space a table would serve; as in the JAX package
        return None
    if hamiltonian.n_valid_configs * hamiltonian.n_connections > max_entries:
        return None
    basis = hamiltonian.enumerate_basis()
    N, C = len(basis), hamiltonian.n_connections
    dev = hamiltonian.device
    basis_dev = to_device(basis, dev)
    keys_sorted, order = torch.sort(keys_device(basis_dev))
    diag = hamiltonian.diagonal_device(basis_dev)
    conn_fn = hamiltonian.connections_device

    target_idx = torch.empty((N, C), dtype=torch.int32, device=dev)
    elems = torch.empty((N, C), dtype=torch.float32, device=dev)
    for start in range(0, N, chunk):
        conn, el = conn_fn(basis_dev[start:start + chunk])
        pos = torch.searchsorted(keys_sorted, keys_device(conn))
        target_idx[start:start + chunk] = order[pos.clamp_(0, N - 1)]
        elems[start:start + chunk] = el
    return DeviceConnectionTable(basis, keys_sorted, order, target_idx,
                                 elems, diag,
                                 unpack_device(basis_dev,
                                               hamiltonian.n_orbitals))
