"""Pauli-word projected Hamiltonian builder.

A copy of the JAX package's ``postprocessing/projected_hamiltonian.py``
(host NumPy): project a Hamiltonian given as Pauli words onto an
integer-encoded basis.  It is independent of the Slater-Condon and spin
connection closures, so the lattice validation CLI uses it as its exact
oracle up to 14 sites.

Vectorized: per word, new_states = basis XOR x_mask and the phase is
i^{n_Y} * (-1)^{popcount(state & z_mask)}; membership through sorted keys
and searchsorted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from ..hamiltonians.base import PauliString

__all__ = ["ProjectedHamiltonianConfig", "ProjectedHamiltonianBuilder"]


def _popcount64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    if hasattr(np, "bitwise_count"):        # numpy >= 2.0: single ufunc
        return np.bitwise_count(x).astype(np.int64)
    c = np.zeros(x.shape, np.int64)
    one = np.uint64(1)
    while np.any(x):
        c += (x & one).astype(np.int64)
        x >>= one
    return c


@dataclass
class ProjectedHamiltonianConfig:
    hermitize: bool = True
    tolerance: float = 1e-12


class ProjectedHamiltonianBuilder:
    """Build H_ij = <basis_i| sum_w c_w P_w |basis_j> over integer states."""

    def __init__(self, paulis: Sequence[PauliString],
                 config: Optional[ProjectedHamiltonianConfig] = None):
        self.paulis = list(paulis)
        self.config = config or ProjectedHamiltonianConfig()

    @classmethod
    def from_coeffs_and_words(cls, coeffs: Sequence[float],
                              words: Sequence[str], **kw):
        return cls([PauliString(w, c) for c, w in zip(coeffs, words)], **kw)

    def build_dense(self, basis_states: np.ndarray) -> np.ndarray:
        """basis_states: (B,) integer-encoded full bitstrings."""
        rows, cols, vals = self._entries(basis_states)
        B = len(basis_states)
        H = np.zeros((B, B), complex)
        np.add.at(H, (rows, cols), vals)
        if self.config.hermitize:
            H = 0.5 * (H + H.conj().T)
        if np.abs(H.imag).max(initial=0.0) < 1e-10:
            return H.real
        return H

    def build_sparse(self, basis_states: np.ndarray) -> sp.csr_matrix:
        rows, cols, vals = self._entries(basis_states)
        B = len(basis_states)
        if np.abs(vals.imag).max(initial=0.0) < 1e-10:
            vals = vals.real
        M = sp.coo_matrix((vals, (rows, cols)), shape=(B, B)).tocsr()
        if self.config.hermitize:
            M = (M + M.conj().T) * 0.5
        return M

    def _entries(self, basis_states: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        states = np.asarray(basis_states, np.uint64)
        B = len(states)
        order = np.argsort(states)
        sorted_states = states[order]

        rows_all: List[np.ndarray] = []
        cols_all: List[np.ndarray] = []
        vals_all: List[np.ndarray] = []
        cols = np.arange(B)
        for p in self.paulis:
            if abs(p.coefficient) < self.config.tolerance:
                continue
            x_mask = np.uint64(p.x_mask)
            new_states = states ^ x_mask
            # phase: product over qubits of Z/Y action on the *input* state
            #   Z: (-1)^b ; Y: i(1-2b) -> i^{nY} * (-1)^{popcount(state&z_mask)}
            z_par = _popcount64(states & np.uint64(p.z_mask)) & 1
            phase = (p.coefficient * (1j) ** p.n_y
                     * np.where(z_par, -1.0, 1.0))
            pos = np.clip(np.searchsorted(sorted_states, new_states),
                          0, B - 1)
            hit = sorted_states[pos] == new_states
            rows_all.append(order[pos[hit]])
            cols_all.append(cols[hit])
            vals_all.append(np.broadcast_to(phase, (B,))[hit])
        if not rows_all:
            z = np.zeros(0)
            return z.astype(int), z.astype(int), z.astype(complex)
        return (np.concatenate(rows_all), np.concatenate(cols_all),
                np.concatenate(vals_all).astype(complex))
