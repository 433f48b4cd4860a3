"""Hamiltonian base: host keys and projected matrices.

Counterpart of the host methods of
``flow_guided_krylov_tpu/hamiltonians/base.py::Hamiltonian``.
Configurations are packed uint32 words (``pack_words`` per configuration:
2 for molecular alpha/beta up to 32 orbitals and 4 above, 1 for spins up
to 31 sites and 2 above), and every configuration has exactly
``n_connections`` connections.
"""

from __future__ import annotations

import sys
from abc import ABC, abstractmethod
import copy
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.bits import _SIGN_FLIP, join2, keys_device, split2, unkey_device
from ..utils.profiling import counted_eigsh

__all__ = ["Hamiltonian", "PauliString", "lex_order", "lowest_pairs",
           "DENSE_SOLVE_MAX_ROWS"]

# a projected basis of at most this many states is built dense
# (``matrix_elements``) and solved by ``eigh``; a larger one is built
# sparse (``to_sparse``) and solved by ``eigsh``
DENSE_SOLVE_MAX_ROWS = 2048


def lowest_pairs(M, k: int = 1, v0: Optional[np.ndarray] = None,
                 tol: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """The ``k`` lowest eigenpairs of the symmetric ``M``, ascending:
    ``np.linalg.eigh`` for a dense array; for a sparse matrix or a
    ``LinearOperator``, ``counted_eigsh`` (``which="SA"``, ``tol``, from
    ``v0`` unless its length is not ``M``'s).  Every host solve of a
    projected basis picks its library call here."""
    if isinstance(M, np.ndarray):
        vals, vecs = np.linalg.eigh(M)
        return vals[:k], vecs[:, :k]
    if v0 is not None and len(v0) != M.shape[0]:
        v0 = None
    vals, vecs = counted_eigsh(M, k=max(k, 1), which="SA", v0=v0, tol=tol)
    idx = np.argsort(vals)
    return vals[idx][:k], vecs[:, idx][:, :k]


def lex_order(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of (R,) int64 keys, or of (R, 2) key pairs
    lexicographically (first column, then second): a stable sort on the
    second column, then a stable sort on the first.  Equal keys keep their
    input order either way, as ``jax.lax.sort(num_keys=W)`` keeps them."""
    if keys.dim() == 1:
        return torch.sort(keys, stable=True).indices
    order = torch.sort(keys[:, 1], stable=True).indices
    return order[torch.sort(keys[order, 0], stable=True).indices]


class _PairKeys:
    """Membership search over a set of (alpha, beta) int64 key pairs with
    one int64 ``searchsorted``: the set's distinct alpha keys and distinct
    beta keys, sorted, rank each channel, and a pair becomes
    ``rank_a * n_beta + rank_b``.  The composite orders the set as the
    lexicographic pair order does, and a pair whose alpha or beta key the
    set lacks is no member."""

    def __init__(self, keys: torch.Tensor):
        self.alpha = torch.unique(keys[:, 0])
        self.beta = torch.unique(keys[:, 1])
        self.own = self.search_key(keys)[0]

    def on(self, device) -> "_PairKeys":
        """The same search with its channel keys on ``device``."""
        from ..parallel.mesh import to
        out = copy.copy(self)
        out.alpha, out.beta = to(self.alpha, device), to(self.beta, device)
        return out

    @staticmethod
    def _rank(values: torch.Tensor, keys: torch.Tensor):
        pos = torch.searchsorted(values, keys).clamp_(max=len(values) - 1)
        return pos, values[pos] == keys

    def search_key(self, keys: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., 2) key pairs -> ((...) composite keys, (...) True where
        both channels' keys occur in the set)."""
        ra, hit_a = self._rank(self.alpha, keys[..., 0].contiguous())
        rb, hit_b = self._rank(self.beta, keys[..., 1].contiguous())
        return ra * len(self.beta) + rb, hit_a & hit_b


class _KeyIndex:
    """The rows of a set of device keys (:meth:`Hamiltonian.keys_device`:
    one int64 a row up to two words, an (alpha, beta) pair at four) by one
    int64 ``searchsorted`` over the sorted keys; pairs search as their
    :class:`_PairKeys` composite.  ``index_dtype`` is the dtype of the rows
    :meth:`find` returns."""

    def __init__(self, keys: torch.Tensor,
                 index_dtype: torch.dtype = torch.int64):
        self.pairs = _PairKeys(keys) if keys.dim() == 2 else None
        if self.pairs is not None:
            keys = self.pairs.own
        self.sorted, order = torch.sort(keys)
        self.order = order.to(index_dtype)

    def on(self, device) -> "_KeyIndex":
        """The same index with its tensors on ``device``."""
        from ..parallel.mesh import to
        out = copy.copy(self)
        out.sorted, out.order = to(self.sorted, device), to(self.order,
                                                            device)
        if self.pairs is not None:
            out.pairs = self.pairs.on(device)
        return out

    def find(self, keys: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device keys of any leading shape -> (their rows in the set,
        True where a key is in the set); a miss's row is arbitrary."""
        member = None
        if self.pairs is not None:
            keys, member = self.pairs.search_key(keys)
        pos = torch.searchsorted(self.sorted, keys).clamp_(
            max=len(self.sorted) - 1)
        hit = self.sorted[pos] == keys
        if member is not None:
            hit &= member
        return self.order[pos], hit


class Hamiltonian(ABC):
    """Abstract Hamiltonian over packed-bitstring configurations.

    * ``n_sites`` — number of qubits.
    * ``pack_words`` — uint32 words per configuration (2: alpha, beta;
      4: two words a channel past 32 orbitals; 1: a spin configuration of
      up to 31 sites; 2: [hi, lo] from 32 to 64 sites).
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

    # the attributes that hold closures or tables built on ``self.device``,
    # each with its empty value: a replica on another device starts them
    # empty (each subclass lists its own)
    DEVICE_CACHES: Dict[str, object] = {}

    def on(self, device) -> "Hamiltonian":
        """This Hamiltonian with its device closures on ``device``: itself
        on its own device, else a shallow copy (kept, one a device) whose
        :attr:`DEVICE_CACHES` start empty, so its connection and diagonal
        functions build their tables on ``device``."""
        from ..parallel.mesh import canonical
        device = canonical(device)
        if device == canonical(self.device):
            return self
        replicas = self.__dict__.setdefault("_replicas", {})
        r = replicas.get(device)
        if r is None:
            r = copy.copy(self)
            r.__dict__.pop("_replicas", None)
            r.device = device
            for attr, empty in self.DEVICE_CACHES.items():
                setattr(r, attr, empty)
            replicas[device] = r
        return r

    # ------------------------------------------------------------------
    # Key encoding (host)
    # ------------------------------------------------------------------

    # 128-bit host key of a 4-word row: compares field by field, i.e. in
    # (alpha, beta) numeric order; np.sort / argsort / searchsorted / ==
    # take structured dtypes, so every key consumer works unchanged
    KEY128 = np.dtype([("a", "<u8"), ("b", "<u8")])

    def keys(self, packed: np.ndarray) -> np.ndarray:
        """(B, W) uint32 -> (B,) sort/dedup keys: the word itself at
        W = 1 (spin configurations), (w0 << 32) | w1 as uint64 at W = 2,
        and at W = 4 (``[a_hi, a_lo, b_hi, b_lo]``) a ``KEY128`` record
        of the two 64-bit channels."""
        packed = np.asarray(packed)
        if self.pack_words == 1:
            # a 1-D array is a batch of one-word rows, as in the JAX base
            return (packed if packed.ndim == 1
                    else packed[..., 0]).astype(np.uint64)
        if sys.byteorder != "little":
            raise RuntimeError("packed-key uint64 views assume a "
                               "little-endian host")
        # write the words low half first and view them as little-endian
        # uint64 (NumPy's uint64 shifts are slow)
        flat = packed.reshape(-1, packed.shape[-1])
        if self.pack_words == 4:
            kk = np.empty((flat.shape[0], 4), np.uint32)
            kk[:, 0] = flat[:, 1]    # alpha low
            kk[:, 1] = flat[:, 0]    # alpha high
            kk[:, 2] = flat[:, 3]    # beta low
            kk[:, 3] = flat[:, 2]    # beta high
            return kk.view(self.KEY128)[:, 0].reshape(packed.shape[:-1])
        kk = np.empty((flat.shape[0], 2), np.uint32)
        kk[:, 0] = flat[:, 1]        # low word
        kk[:, 1] = flat[:, 0]        # high word
        return kk.view(np.uint64)[:, 0].reshape(packed.shape[:-1])

    def keys_device(self, packed: torch.Tensor) -> torch.Tensor:
        """(..., W) int64 device words -> int64 sort/search keys that
        order like :meth:`keys`: (...) the word itself at W = 1 (below
        2^31, so signed order is unsigned order), ``ops.bits.keys_device``
        at W = 2; at W = 4 a (..., 2) pair (alpha, beta) of 64-bit
        channels, each with its top bit flipped.  A pair orders
        lexicographically (:func:`lex_order`)."""
        if self.pack_words == 1:
            return packed[..., 0]
        if self.pack_words == 4:
            return torch.stack([join2(packed[..., 0:2]),
                                join2(packed[..., 2:4])], -1) ^ _SIGN_FLIP
        return keys_device(packed)

    def unkey_device(self, keys: torch.Tensor) -> torch.Tensor:
        """Device keys of :meth:`keys_device` -> (..., W) int64 words."""
        if self.pack_words == 1:
            return keys[..., None]
        if self.pack_words == 4:
            return split2(keys ^ _SIGN_FLIP).flatten(-2)
        return unkey_device(keys)

    def keys_to_host(self, keys: torch.Tensor) -> np.ndarray:
        """Device keys of :meth:`keys_device` -> the host keys of
        :meth:`keys` (``unkey`` then gives the packed rows)."""
        k = keys.cpu().numpy()
        if self.pack_words == 1:
            return k.astype(np.uint64)
        u = k.view(np.uint64) ^ np.uint64(1 << 63)
        if self.pack_words == 4:
            return np.ascontiguousarray(u).view(self.KEY128)[:, 0]
        return u

    def unkey(self, keys: np.ndarray) -> np.ndarray:
        """(B,) keys -> (B, W) uint32 packed rows (inverse of
        :meth:`keys`)."""
        if self.pack_words == 4:
            w = np.asarray(keys, dtype=self.KEY128).reshape(-1, 1
                                                            ).view(np.uint32)
            return np.stack([w[:, 1], w[:, 0], w[:, 3], w[:, 2]], axis=-1)
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

    def projected(self, basis: np.ndarray):
        """H projected on ``basis`` and symmetrized (host f64): a dense
        array from :meth:`matrix_elements` up to ``DENSE_SOLVE_MAX_ROWS``
        states (with a warning when its asymmetry passes 1e-8), a CSR
        matrix from :meth:`to_sparse` above."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        if basis.shape[0] <= DENSE_SOLVE_MAX_ROWS:
            H = self.matrix_elements(basis, basis)
            asym = np.max(np.abs(H - H.T))
            if asym > 1e-8:
                import warnings
                warnings.warn(f"projected H asymmetry {asym:.2e}; symmetrizing")
            return 0.5 * (H + H.T)
        M = self.to_sparse(basis)
        return (M + M.T) * 0.5

    def exact_ground_state(self, basis: np.ndarray, k: int = 1,
                           v0: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Lowest-k eigenpairs of H projected onto ``basis``
        (:meth:`projected`, then :func:`lowest_pairs`)."""
        return lowest_pairs(self.projected(basis), k=k, v0=v0)


class PauliString:
    """A Pauli word (I/X/Y/Z per qubit) acting on packed full bitstrings.

    A copy of the JAX package's ``hamiltonians/base.py::PauliString``
    (host Python).  Qubit q in state b: X flips it, Z phases it by
    (-1)^b, and Y uses the standard convention Y|0> = i|1>,
    Y|1> = -i|0>.
    """

    def __init__(self, paulis: str, coefficient: complex = 1.0):
        self.paulis = paulis.upper()
        self.coefficient = complex(coefficient)
        if set(self.paulis) - set("IXYZ"):
            raise ValueError(f"invalid Pauli string {paulis!r}")
        self.x_mask = 0
        self.z_mask = 0
        for q, p in enumerate(self.paulis):
            if p in "XY":
                self.x_mask |= (1 << q)
            if p in "ZY":
                self.z_mask |= (1 << q)
        self.n_y = sum(1 for p in self.paulis if p == "Y")

    @property
    def is_diagonal(self) -> bool:
        return self.x_mask == 0

    def apply(self, state: int) -> Tuple[int, complex]:
        """Return (new_state, phase) for P|state>."""
        new_state = state ^ self.x_mask
        # phase: product over qubits; standard formula
        # <new|P|state> = i^{n_y} * (-1)^{popcount(state & z_mask)} * (-i)^{...}
        # Derive directly: X: 1; Z: (-1)^b; Y on bit b: b=0 -> i, b=1 -> -i.
        phase = self.coefficient
        for q, p in enumerate(self.paulis):
            b = (state >> q) & 1
            if p == "Z":
                phase *= (-1) ** b
            elif p == "Y":
                phase *= (1j if b == 0 else -1j)
        return new_state, phase

    def __repr__(self) -> str:
        return f"PauliString({self.paulis!r}, {self.coefficient})"
