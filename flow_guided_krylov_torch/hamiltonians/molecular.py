"""Molecular Hamiltonian over packed determinants.

Counterpart of ``flow_guided_krylov_tpu/hamiltonians/molecular.py``.
Alpha orbitals sit on Jordan-Wigner qubits 0..n-1, beta on n..2n-1.  Up to
32 orbitals a determinant is a (2,) row of channel words; from 33 to 64
each channel spans two words, ``[a_hi, a_lo, b_hi, b_lo]`` (``pack_words``
4, 128-bit host keys).  Host integrals come from the port's own ``chem``
(NumPy and the shared C++ ERI engine).  Device compute runs on
``device``, which the caller names; every downstream consumer uses this
device.
"""

from __future__ import annotations

from itertools import combinations
from math import comb
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..chem import MolecularIntegrals, compute_molecular_integrals
from ..ops.slater import (SlaterTables, build_tables, connections_batch_np,
                          diagonal_batch, diagonal_batch_np,
                          make_connection_fn_auto)
from .base import Hamiltonian, PauliString

__all__ = [
    "MolecularIntegrals", "MolecularHamiltonian",
    "create_h2_hamiltonian", "create_lih_hamiltonian",
    "create_h2o_hamiltonian", "create_beh2_hamiltonian",
    "create_nh3_hamiltonian", "create_n2_hamiltonian",
    "create_ch4_hamiltonian", "MOLECULE_FACTORIES",
    "synthetic_integrals", "create_synthetic_hamiltonian",
]


class MolecularHamiltonian(Hamiltonian):
    """Molecular Hamiltonian with particle-conserving determinant algebra."""

    pack_words = 2
    DEVICE_CACHES = {"_conn_fn": None}

    def __init__(self, integrals: MolecularIntegrals, device):
        self.integrals = integrals
        self.device = torch.device(device)
        self.n_orbitals = integrals.n_orbitals
        self.n_alpha = integrals.n_alpha
        self.n_beta = integrals.n_beta
        self.n_electrons = integrals.n_electrons
        # 33..64 orbitals span two uint32 words per spin channel
        self.pack_words = 4 if self.n_orbitals > 32 else 2
        self.n_sites = 2 * self.n_orbitals  # qubits
        self.n_qubits = self.n_sites
        self.tables: SlaterTables = build_tables(
            integrals.h1e, integrals.h2e, integrals.nuclear_repulsion,
            integrals.n_alpha, integrals.n_beta)
        self._conn_fn = None
        self._fci_cache: Optional[Tuple[float, np.ndarray, np.ndarray]] = None
        self._fci_energy_cache: Optional[float] = None

    # ------------------------------------------------------------------
    # Counting / enumeration
    # ------------------------------------------------------------------

    @property
    def n_valid_configs(self) -> int:
        n = self.n_orbitals
        return comb(n, self.n_alpha) * comb(n, self.n_beta)

    @property
    def n_connections(self) -> int:
        return self.tables.n_connections

    def enumerate_basis(self) -> np.ndarray:
        """All C(n,na)*C(n,nb) particle-conserving determinants,
        (B, pack_words) uint32."""
        n = self.n_orbitals
        if self.n_valid_configs > 200_000_000:
            raise NotImplementedError(
                f"enumerate_basis: {self.n_valid_configs} configs is not "
                "enumerable — use the Selected-CI machinery")

        def channel_words(k):
            ints = [sum(1 << i for i in c)
                    for c in combinations(range(n), k)]
            if n <= 32:
                return np.array(ints, dtype=np.uint32)[:, None]
            arr = np.array(ints, dtype=np.uint64)
            return np.stack([(arr >> np.uint64(32)).astype(np.uint32),
                             (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                            axis=-1)                 # [hi, lo]

        alphas = channel_words(self.n_alpha)
        betas = channel_words(self.n_beta)
        a = np.repeat(alphas, len(betas), axis=0)
        b = np.tile(betas, (len(alphas), 1))
        return np.concatenate([a, b], axis=-1)

    def get_hf_state(self) -> np.ndarray:
        """Aufbau reference determinant, (pack_words,) uint32."""

        def channel(k):
            bits = (1 << k) - 1
            if self.n_orbitals <= 32:
                return [bits]
            return [bits >> 32, bits & 0xFFFFFFFF]   # [hi, lo]

        return np.array(channel(self.n_alpha) + channel(self.n_beta),
                        dtype=np.uint32)

    # ------------------------------------------------------------------
    # Kernels
    # ------------------------------------------------------------------

    def diagonal_np(self, packed: np.ndarray) -> np.ndarray:
        return diagonal_batch_np(np.atleast_2d(packed), self.tables)

    def connections_np(self, packed: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        return connections_batch_np(np.atleast_2d(packed), self.tables)

    def diagonal_device(self, packed: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, pack_words) int64 words on ``self.device`` -> (B,) diagonal
        in ``dtype`` (float64 for the multiword dE2's denominators)."""
        return diagonal_batch(packed, self.tables, dtype)

    @property
    def connections_device(self):
        """f(packed (B, W) int64) -> ((B, C, W) int64, (B, C) float32) on
        ``self.device``, W = ``pack_words`` (see
        ``ops/slater.py::make_connection_fn_auto``)."""
        if self._conn_fn is None:
            self._conn_fn = make_connection_fn_auto(self.tables, self.device)
        return self._conn_fn

    # ------------------------------------------------------------------
    # FCI (exactness oracle)
    # ------------------------------------------------------------------

    def exact_full(self, k: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(energies, vectors, basis) in the particle-conserving subspace."""
        basis = self.enumerate_basis()
        vals, vecs = self.exact_ground_state(basis, k=k)
        return vals, vecs, basis

    def _fci_disk_cache_path(self):
        """Disk-cache location for the FCI oracle energy, keyed by the
        integral content.  The ``torch_fci_`` prefix keeps the port's own
        oracle apart from the JAX package's ``fci_`` entries."""
        import hashlib
        import os
        from pathlib import Path
        i = self.integrals
        hsh = hashlib.sha1()
        hsh.update(np.ascontiguousarray(i.h1e).tobytes())
        hsh.update(np.ascontiguousarray(i.h2e).tobytes())
        hsh.update(np.float64(i.nuclear_repulsion).tobytes())
        hsh.update(bytes([i.n_alpha, i.n_beta, i.n_orbitals]))
        root = Path(os.environ.get(
            "FGK_INTEGRAL_CACHE",
            Path.home() / ".cache" / "fgk_tpu_integrals"))
        return root / f"torch_fci_{hsh.hexdigest()}.txt"

    def fci_energy(self) -> float:
        if self._fci_cache is not None:
            return self._fci_cache[0]
        if self._fci_energy_cache is not None:
            return self._fci_energy_cache
        path = self._fci_disk_cache_path()
        try:
            self._fci_energy_cache = float(path.read_text())
            return self._fci_energy_cache
        except (OSError, ValueError):
            pass
        vals, vecs, basis = self.exact_full(k=1)
        self._fci_cache = (float(vals[0]), vecs[:, 0], basis)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(repr(self._fci_cache[0]))
        except OSError:
            pass
        return self._fci_cache[0]

    def fci_state(self) -> Tuple[float, np.ndarray, np.ndarray]:
        if self._fci_cache is None:
            # the disk cache holds the energy only — the state needs a
            # real solve
            vals, vecs, basis = self.exact_full(k=1)
            self._fci_cache = (float(vals[0]), vecs[:, 0], basis)
        return self._fci_cache

    # ------------------------------------------------------------------
    # Pauli-word export (for the Krylov circuit sampler interface)
    # ------------------------------------------------------------------

    def to_pauli_strings(self, threshold: float = 1e-10) -> List[PauliString]:
        """Jordan-Wigner Pauli decomposition (one-body + diagonal two-body).

        A copy of the JAX package's: full one-body terms and the diagonal
        (number-number) part of the two-body interaction; used by the
        circuit-sampling integration point, not the main pipeline.
        """
        n = self.n_orbitals
        nq = self.n_sites
        h1 = self.integrals.h1e
        terms: dict = {}

        def add(word: str, coef: complex):
            if abs(coef) < threshold:
                return
            terms[word] = terms.get(word, 0.0) + coef

        ident = "I" * nq
        add(ident, self.integrals.nuclear_repulsion)

        for spin_off in (0, n):
            for p in range(n):
                q_p = p + spin_off
                # number operator: n_p = (I - Z_p)/2
                add(ident, 0.5 * h1[p, p])
                w = list(ident)
                w[q_p] = "Z"
                add("".join(w), -0.5 * h1[p, p])
                for q in range(p + 1, n):
                    if abs(h1[p, q]) < threshold:
                        continue
                    q_q = q + spin_off
                    # hopping: h_pq (a+_p a_q + h.c.)
                    #   = h_pq/2 (X_p Z.. X_q + Y_p Z.. Y_q)
                    for op in ("X", "Y"):
                        w = list(ident)
                        w[q_p] = op
                        w[q_q] = op
                        for z in range(q_p + 1, q_q):
                            w[z] = "Z"
                        add("".join(w), 0.5 * h1[p, q])

        # diagonal two-body: 1/2 sum J_pq N_p N_q - 1/2 K same-spin,
        # expressed via n_p n_q -> (I - Z_p - Z_q + Z_p Z_q)/4
        jmat, kmat = self.tables.jmat, self.tables.kmat

        def add_nn(qa: int, qb: int, coef: float):
            if qa == qb:
                # n^2 = n for fermions
                add(ident, 0.5 * coef)
                w = list(ident)
                w[qa] = "Z"
                add("".join(w), -0.5 * coef)
                return
            add(ident, 0.25 * coef)
            for qq in (qa, qb):
                w = list(ident)
                w[qq] = "Z"
                add("".join(w), -0.25 * coef)
            w = list(ident)
            w[qa] = "Z"
            w[qb] = "Z"
            add("".join(w), 0.25 * coef)

        for p in range(n):
            for q in range(n):
                for so1 in (0, n):
                    for so2 in (0, n):
                        coef = 0.5 * jmat[p, q]
                        if so1 == so2:
                            coef -= 0.5 * kmat[p, q]
                        add_nn(p + so1, q + so2, coef)

        return [PauliString(w, c) for w, c in terms.items()
                if abs(c) > threshold]


# ---------------------------------------------------------------------------
# Molecule factories — the JAX package's geometries
# ---------------------------------------------------------------------------

def create_h2_hamiltonian(device, bond_length: float = 0.74
                          ) -> MolecularHamiltonian:
    geometry = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, bond_length))]
    return MolecularHamiltonian(compute_molecular_integrals(geometry), device)


def create_lih_hamiltonian(device, bond_length: float = 1.6
                           ) -> MolecularHamiltonian:
    geometry = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, bond_length))]
    return MolecularHamiltonian(compute_molecular_integrals(geometry), device)


def create_h2o_hamiltonian(device, oh_length: float = 0.96,
                           angle: float = 104.5) -> MolecularHamiltonian:
    ang = np.radians(angle)
    geometry = [
        ("O", (0.0, 0.0, 0.0)),
        ("H", (oh_length, 0.0, 0.0)),
        ("H", (oh_length * np.cos(ang), oh_length * np.sin(ang), 0.0)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry), device)


def create_beh2_hamiltonian(device, bond_length: float = 1.33
                            ) -> MolecularHamiltonian:
    geometry = [
        ("Be", (0.0, 0.0, 0.0)),
        ("H", (0.0, 0.0, bond_length)),
        ("H", (0.0, 0.0, -bond_length)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry), device)


def create_nh3_hamiltonian(device, nh_length: float = 1.01,
                           hnh_angle: float = 107.8) -> MolecularHamiltonian:
    ang = np.radians(hnh_angle)
    h = nh_length * np.cos(np.arcsin(np.sin(ang / 2) / np.sin(np.radians(60))))
    r = np.sqrt(nh_length ** 2 - h ** 2)
    geometry = [
        ("N", (0.0, 0.0, h)),
        ("H", (r, 0.0, 0.0)),
        ("H", (r * np.cos(np.radians(120)), r * np.sin(np.radians(120)), 0.0)),
        ("H", (r * np.cos(np.radians(240)), r * np.sin(np.radians(240)), 0.0)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry), device)


def create_n2_hamiltonian(device, bond_length: float = 1.10
                          ) -> MolecularHamiltonian:
    geometry = [("N", (0.0, 0.0, 0.0)), ("N", (0.0, 0.0, bond_length))]
    return MolecularHamiltonian(compute_molecular_integrals(geometry), device)


def create_ch4_hamiltonian(device, ch_length: float = 1.09
                           ) -> MolecularHamiltonian:
    a = ch_length / np.sqrt(3)
    geometry = [
        ("C", (0.0, 0.0, 0.0)),
        ("H", (a, a, a)), ("H", (a, -a, -a)),
        ("H", (-a, a, -a)), ("H", (-a, -a, a)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry), device)


def synthetic_integrals(n: int, ka: int, kb: int, seed: int = 0
                        ) -> MolecularIntegrals:
    """Random integrals with the 8-fold chemist symmetry, made from
    ``seed`` (as ``bench.py``): n orbitals, ka alpha and kb beta
    electrons."""
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(n, n))
    h1 = 0.5 * (h1 + h1.T)
    h2 = rng.normal(size=(n,) * 4) * 0.1
    h2 = h2 + h2.transpose(1, 0, 2, 3)
    h2 = h2 + h2.transpose(0, 1, 3, 2)
    h2 = h2 + h2.transpose(2, 3, 0, 1)
    return MolecularIntegrals(h1e=h1, h2e=h2 / 8, nuclear_repulsion=0.5,
                              n_electrons=ka + kb, n_orbitals=n,
                              n_alpha=ka, n_beta=kb)


def create_synthetic_hamiltonian(n: int, ka: int, kb: int, device,
                                 seed: int = 0) -> MolecularHamiltonian:
    return MolecularHamiltonian(synthetic_integrals(n, ka, kb, seed), device)


MOLECULE_FACTORIES = {
    "h2": create_h2_hamiltonian,
    "lih": create_lih_hamiltonian,
    "h2o": create_h2o_hamiltonian,
    "beh2": create_beh2_hamiltonian,
    "nh3": create_nh3_hamiltonian,
    "n2": create_n2_hamiltonian,
    "ch4": create_ch4_hamiltonian,
}
