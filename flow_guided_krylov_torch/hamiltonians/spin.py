"""Spin-lattice Hamiltonians over packed bitstrings, single word.

Counterpart of ``flow_guided_krylov_tpu/hamiltonians/spin.py`` for chains
of up to 31 sites, where a configuration is one uint32 word (site i in
bit i):

* :class:`HeisenbergHamiltonian` — XXZ plus fields: diagonal
  Jz/4 * sum_bonds s_i s_j + sum_i h_z/2 s_i; off-diagonal
  antiparallel-bond flips with element (Jx+Jy)/4 and single X-field flips
  h_x/2.
* :class:`TransverseFieldIsing` — H = -V sum_edges Z_i Z_j - h sum_i X_i
  with range-L (optionally periodic) interactions.
* :func:`extract_coeffs_and_paulis` — spin H -> Pauli words, the input of
  the Trotter propagator and the circuit sampler.

Matrix elements are host f64, as in the JAX package; the spin path's
device work is the statevector Trotter propagator in ``krylov/skqd.py``.
The Hamiltonian names the device that work runs on (``device=``).  The
two-word layout (32..64 sites), the full-space statevector routes and the
device connection closures are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import Hamiltonian

__all__ = ["HeisenbergHamiltonian", "TransverseFieldIsing",
           "create_heisenberg_hamiltonian", "create_tfim_hamiltonian",
           "extract_coeffs_and_paulis", "pack_spin_state",
           "spin_state_int"]

MAX_SPINS = 31


def _spin_words(n: int) -> int:
    """uint32 words per configuration: 1 for n <= 31.  The two-word
    layout of 32..64 sites is not ported yet."""
    if n > MAX_SPINS:
        raise NotImplementedError(
            f"{n} spins need the two-word layout, which the port does not "
            f"have yet (at most {MAX_SPINS} spins)")
    return 1


def pack_spin_state(x: int, n: int) -> np.ndarray:
    """Python-int spin configuration -> (1,) uint32 packed row."""
    _spin_words(n)
    return np.array([x], np.uint32)


def spin_state_int(row: np.ndarray) -> int:
    """(1,) uint32 packed row -> Python-int spin configuration."""
    return int(np.asarray(row).reshape(-1)[0])


def _site_mask(sites: Sequence[int]) -> np.ndarray:
    """XOR mask (1,) uint32 flipping the given sites."""
    m = np.zeros(1, np.uint32)
    for s in sites:
        m[0] |= np.uint32(1 << s)
    return m


def _bit_np(packed: np.ndarray, s: int) -> np.ndarray:
    """(B, 1) uint32, site index -> (B,) uint32 occupation bit."""
    return (packed[:, 0] >> np.uint32(s)) & np.uint32(1)


def _spins(packed: np.ndarray, n: int) -> np.ndarray:
    """(B, 1) packed -> (B, n) {-1,+1} float64."""
    packed = np.atleast_2d(packed)
    shifts = np.arange(n, dtype=np.uint32)
    bits = (packed[:, 0:1] >> shifts) & 1
    return 2.0 * bits.astype(np.float64) - 1.0


class _SpinBase(Hamiltonian):
    pack_words = 1

    def _init_common(self, num_spins: int, device) -> None:
        self.pack_words = _spin_words(num_spins)
        self.n_sites = num_spins
        self.device = torch.device(device)

    def exact_dense(self) -> np.ndarray:
        """Dense H over the full 2^n space (for n <= ~14; test oracle)."""
        states = np.arange(1 << self.n_sites, dtype=np.uint32)[:, None]
        return self.matrix_elements(states, states)


class HeisenbergHamiltonian(_SpinBase):
    def __init__(self, num_spins: int, Jx: float = 1.0, Jy: float = 1.0,
                 Jz: float = 1.0, h_x: Optional[np.ndarray] = None,
                 h_y: Optional[np.ndarray] = None,
                 h_z: Optional[np.ndarray] = None, periodic: bool = False,
                 *, device):
        self._init_common(num_spins, device)
        # The connections carry the XXZ flip-flop (Jx+Jy)/4 on antiparallel
        # bonds only; anisotropic XY (Jx != Jy) adds parallel-bond flips
        # and an h_y field adds Y single-spin terms, neither of which the
        # connections or the diagonal carry.  Refuse them here, so that the
        # matrix-element and Trotter paths can never use different
        # Hamiltonians.
        if abs(Jx - Jy) > 1e-12:
            raise NotImplementedError(
                "anisotropic XY (Jx != Jy) is not supported: the connections "
                "only implement the (Jx+Jy)/4 flip-flop terms")
        if h_y is not None and np.any(np.abs(np.asarray(h_y, float)) > 1e-12):
            raise NotImplementedError(
                "h_y fields are not supported by the connections")
        self.Jx, self.Jy, self.Jz = Jx, Jy, Jz
        zeros = np.zeros(num_spins)
        self.h_x = np.asarray(h_x if h_x is not None else zeros, float)
        self.h_y = np.asarray(h_y if h_y is not None else zeros, float)
        self.h_z = np.asarray(h_z if h_z is not None else zeros, float)
        self.periodic = periodic
        self.bonds = [(i, i + 1) for i in range(num_spins - 1)]
        if periodic and num_spins > 2:
            self.bonds.append((num_spins - 1, 0))
        self._has_x_field = bool(np.any(np.abs(self.h_x) > 1e-10))

    @property
    def conserves_magnetization(self) -> bool:
        """True when total S_z commutes with H: the Jz diagonal, the
        antiparallel bond flips and h_z all conserve it; only a transverse
        x or y field breaks it.  SKQD then evolves inside the
        fixed-popcount sector of the initial state."""
        return not (self._has_x_field
                    or bool(np.any(np.abs(self.h_y) > 1e-10)))

    @property
    def n_connections(self) -> int:
        return len(self.bonds) + (self.n_sites if self._has_x_field else 0)

    def diagonal_np(self, packed: np.ndarray) -> np.ndarray:
        s = _spins(np.atleast_2d(packed), self.n_sites)
        diag = np.zeros(s.shape[0])
        for i, j in self.bonds:
            diag += self.Jz / 4.0 * s[:, i] * s[:, j]
        diag += (s * (self.h_z / 2.0)).sum(axis=1)
        return diag

    def connections_np(self, packed: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        packed = np.atleast_2d(packed).astype(np.uint32)
        B = packed.shape[0]
        conns = []
        elems = []
        # bond flips: element (Jx+Jy)/4 when antiparallel, else 0
        for i, j in self.bonds:
            anti = _bit_np(packed, i) != _bit_np(packed, j)
            conns.append(packed ^ _site_mask((i, j))[None, :])
            elems.append(np.where(anti, (self.Jx + self.Jy) / 4.0, 0.0))
        if self._has_x_field:
            for i in range(self.n_sites):
                conns.append(packed ^ _site_mask((i,))[None, :])
                elems.append(np.full(B, self.h_x[i] / 2.0))
        conn = np.stack(conns, axis=1)                  # (B, C, 1)
        el = np.stack(elems, axis=1)
        return conn.astype(np.uint32), el


class TransverseFieldIsing(_SpinBase):
    def __init__(self, num_spins: int, V: float = 1.0, h: float = 1.0,
                 L: int = 1, periodic: bool = True, *, device):
        self._init_common(num_spins, device)
        self.V, self.h, self.L = V, h, L
        self.periodic = periodic
        edges = []
        for i in range(num_spins):
            for d in range(1, L + 1):
                j = (i + d) % num_spins if periodic else i + d
                if j < num_spins and (i, j) not in edges \
                        and (j, i) not in edges and i != j:
                    edges.append((i, j))
        self.edges = edges

    @property
    def n_connections(self) -> int:
        return self.n_sites

    def diagonal_np(self, packed: np.ndarray) -> np.ndarray:
        s = _spins(np.atleast_2d(packed), self.n_sites)
        diag = np.zeros(s.shape[0])
        for i, j in self.edges:
            diag -= self.V * s[:, i] * s[:, j]
        return diag

    def connections_np(self, packed: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        packed = np.atleast_2d(packed).astype(np.uint32)
        conns = [packed ^ _site_mask((i,))[None, :]
                 for i in range(self.n_sites)]
        conn = np.stack(conns, axis=1)                  # (B, C, 1)
        el = np.full((packed.shape[0], self.n_sites), -self.h)
        return conn.astype(np.uint32), el


def create_heisenberg_hamiltonian(num_spins: int, Jx: float = 1.0,
                                  Jy: float = 1.0, Jz: float = 1.0,
                                  h_x=None, h_y=None, h_z=None,
                                  periodic: bool = False, *, device
                                  ) -> HeisenbergHamiltonian:
    return HeisenbergHamiltonian(num_spins, Jx, Jy, Jz, h_x, h_y, h_z,
                                 periodic, device=device)


def create_tfim_hamiltonian(num_spins: int, V: float = 1.0, h: float = 1.0,
                            L: int = 1, periodic: bool = True, *, device
                            ) -> TransverseFieldIsing:
    return TransverseFieldIsing(num_spins, V, h, L, periodic, device=device)


def extract_coeffs_and_paulis(hamiltonian) -> Tuple[List[float], List[str]]:
    """Spin H -> (coefficients, Pauli words), site q at position q of each
    word."""
    n = hamiltonian.n_sites
    coeffs: List[float] = []
    words: List[str] = []

    def word(ops: dict) -> str:
        return "".join(ops.get(q, "I") for q in range(n))

    if isinstance(hamiltonian, TransverseFieldIsing):
        for i, j in hamiltonian.edges:
            coeffs.append(-hamiltonian.V)
            words.append(word({i: "Z", j: "Z"}))
        for i in range(n):
            coeffs.append(-hamiltonian.h)
            words.append(word({i: "X"}))
    elif isinstance(hamiltonian, HeisenbergHamiltonian):
        for i, j in hamiltonian.bonds:
            for op, J in (("X", hamiltonian.Jx), ("Y", hamiltonian.Jy),
                          ("Z", hamiltonian.Jz)):
                if abs(J) > 1e-12:
                    coeffs.append(J / 4.0)
                    words.append(word({i: op, j: op}))
        for i in range(n):
            for op, harr in (("X", hamiltonian.h_x), ("Y", hamiltonian.h_y),
                             ("Z", hamiltonian.h_z)):
                if abs(harr[i]) > 1e-12:
                    # the spin map s = 2b - 1 gives Z|b> = (1-2b)|b> = -s|b>,
                    # so single-Z coefficients flip sign relative to the
                    # h_z/2 * s_i diagonal convention
                    sign = -1.0 if op == "Z" else 1.0
                    coeffs.append(sign * harr[i] / 2.0)
                    words.append(word({i: op}))
    else:
        raise TypeError(f"unsupported Hamiltonian {type(hamiltonian)}")
    return coeffs, words
