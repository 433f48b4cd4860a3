"""Hamiltonian base: host keys and projected matrices.

Counterpart of the host methods of
``flow_guided_krylov_tpu/hamiltonians/base.py::Hamiltonian``.
Configurations are packed uint32 words (``pack_words`` per configuration;
2 for molecular alpha/beta, 1 for spins), and every configuration has exactly
``n_connections`` connections.
"""

from __future__ import annotations

import sys
from abc import ABC, abstractmethod
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

__all__ = ["Hamiltonian"]


class Hamiltonian(ABC):
    """Abstract Hamiltonian over packed-bitstring configurations.

    * ``n_sites`` — number of qubits.
    * ``pack_words`` — uint32 words per configuration (2: alpha, beta;
      1: a spin configuration of up to 31 sites).
    * ``n_connections`` — static per-config connection count.
    * ``diagonal_np(packed)`` — host f64 diagonal elements.
    * ``connections_np(packed)`` — host f64 ((B,C,W) targets, (B,C) elems).
    """

    n_sites: int
    pack_words: int

    @property
    @abstractmethod
    def n_connections(self) -> int:
        ...

    @abstractmethod
    def diagonal_np(self, packed: np.ndarray) -> np.ndarray:
        ...

    @abstractmethod
    def connections_np(self, packed: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        ...

    # ------------------------------------------------------------------
    # Key encoding (host)
    # ------------------------------------------------------------------

    def keys(self, packed: np.ndarray) -> np.ndarray:
        """(B, W) uint32 -> (B,) uint64 sort/dedup keys: the word itself
        at W = 1 (spin configurations), (alpha << 32) | beta at W = 2."""
        packed = np.asarray(packed)
        if self.pack_words == 1:
            # a 1-D array is a batch of one-word rows, as in the JAX base
            return (packed if packed.ndim == 1
                    else packed[..., 0]).astype(np.uint64)
        if sys.byteorder != "little":
            raise RuntimeError("packed-key uint64 views assume a "
                               "little-endian host")
        # (alpha << 32) | beta: write [beta, alpha] uint32 pairs and view
        # them as little-endian uint64 (NumPy's uint64 shifts are slow)
        flat = packed.reshape(-1, packed.shape[-1])
        kk = np.empty((flat.shape[0], 2), np.uint32)
        kk[:, 0] = flat[:, 1]        # low word: beta
        kk[:, 1] = flat[:, 0]        # high word: alpha
        return kk.view(np.uint64)[:, 0].reshape(packed.shape[:-1])

    def unkey(self, keys: np.ndarray) -> np.ndarray:
        """(B,) uint64 keys -> (B, W) uint32 packed rows (inverse of
        :meth:`keys`)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if self.pack_words == 1:
            return keys.astype(np.uint32)[:, None]
        a = (keys >> np.uint64(32)).astype(np.uint32)
        b = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return np.stack([a, b], axis=-1)

    # ------------------------------------------------------------------
    # Projected matrices (host, float64)
    # ------------------------------------------------------------------

    def matrix_elements(self, bra: np.ndarray, ket: np.ndarray) -> np.ndarray:
        """Dense <bra_i|H|ket_j> (host f64): diagonal + connection scatter
        through a sorted-key membership map."""
        bra = np.atleast_2d(np.asarray(bra, np.uint32))
        ket = np.atleast_2d(np.asarray(ket, np.uint32))
        nb, nk = bra.shape[0], ket.shape[0]
        bra_keys = self.keys(bra)
        order = np.argsort(bra_keys)
        sorted_keys = bra_keys[order]

        H = np.zeros((nb, nk))
        ket_keys = self.keys(ket)
        pos = np.searchsorted(sorted_keys, ket_keys)
        pos_c = np.clip(pos, 0, nb - 1)
        hit = sorted_keys[pos_c] == ket_keys
        diag = self.diagonal_np(ket)
        H[order[pos_c[hit]], np.arange(nk)[hit]] = diag[hit]

        conn, elems = self.connections_np(ket)
        ck = self.keys(conn.reshape(-1, conn.shape[-1]))
        pos = np.searchsorted(sorted_keys, ck)
        pos_c = np.clip(pos, 0, nb - 1)
        hit = sorted_keys[pos_c] == ck
        cols = np.repeat(np.arange(nk), conn.shape[1])
        np.add.at(H, (order[pos_c[hit]], cols[hit]), elems.reshape(-1)[hit])
        return H

    def to_sparse(self, basis: np.ndarray) -> sp.csr_matrix:
        """Sparse projected H over ``basis`` (host f64 CSR)."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        B = basis.shape[0]
        keys = self.keys(basis)
        order = np.argsort(keys)
        sorted_keys = keys[order]
        order32 = order.astype(np.int32)

        # fused native path (molecular Slater tables): enumeration +
        # membership + values for hits only
        from ..ops.native_conn import conn_hits_native
        nat = conn_hits_native(self, basis, sorted_keys)
        if nat is not None:
            src, spos, vals = nat
            rows = order32[spos]
            cols = src
        else:
            conn, elems = self.connections_np(basis)
            ck = self.keys(conn.reshape(-1, conn.shape[-1]))
            pos = np.clip(np.searchsorted(sorted_keys, ck), 0, B - 1
                          ).astype(np.int32)
            hit = sorted_keys[pos] == ck
            rows = order32[pos[hit]]
            cols = np.repeat(np.arange(B, dtype=np.int32),
                             conn.shape[1])[hit]
            vals = elems.reshape(-1)[hit]

        diag = self.diagonal_np(basis)
        rng = np.arange(B, dtype=np.int32)
        rows = np.concatenate([rows, rng])
        cols = np.concatenate([cols, rng])
        vals = np.concatenate([vals, diag])
        return sp.coo_matrix((vals, (rows, cols)), shape=(B, B)).tocsr()

    def exact_ground_state(self, basis: np.ndarray, k: int = 1,
                           v0: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Lowest-k eigenpairs of H projected onto ``basis``: dense eigh
        up to 2048 states, sparse eigsh above."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        B = basis.shape[0]
        if B <= 2048:
            H = self.matrix_elements(basis, basis)
            asym = np.max(np.abs(H - H.T))
            if asym > 1e-8:
                import warnings
                warnings.warn(f"projected H asymmetry {asym:.2e}; symmetrizing")
            H = 0.5 * (H + H.T)
            vals, vecs = np.linalg.eigh(H)
            return vals[:k], vecs[:, :k]
        M = self.to_sparse(basis)
        M = (M + M.T) * 0.5
        if v0 is not None and len(v0) != B:
            v0 = None
        vals, vecs = spla.eigsh(M, k=max(k, 2), which="SA", v0=v0)
        idx = np.argsort(vals)
        return vals[idx][:k], vecs[:, idx][:, :k]
