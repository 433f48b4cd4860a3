"""Spin-lattice Hamiltonians over packed bitstrings.

Counterpart of ``flow_guided_krylov_tpu/hamiltonians/spin.py``.  A
configuration of up to 31 sites is one uint32 word (site i in bit i); from
32 to 64 sites it is two, in columns [hi, lo] (sites 0..31 in the low word,
the last column), so the uint64 host key (hi << 32) | lo orders like the
integer state:

* :class:`HeisenbergHamiltonian` — XXZ plus fields: diagonal
  Jz/4 * sum_bonds s_i s_j + sum_i h_z/2 s_i; off-diagonal
  antiparallel-bond flips with element (Jx+Jy)/4 and single X-field flips
  h_x/2.
* :class:`TransverseFieldIsing` — H = -V sum_edges Z_i Z_j - h sum_i X_i
  with range-L (optionally periodic) interactions.
* :func:`extract_coeffs_and_paulis` — spin H -> Pauli words, the input of
  the Trotter propagator and the circuit sampler.

Matrix elements are host f64, as in the JAX package.  The device work
is the statevector Trotter propagator in ``krylov/skqd.py``, the device
closures ``diagonal_device`` / ``connections_device`` (float32 elements
over int64 words, the source of the sector and full-space ELL tables) and
the table-free full-space product :meth:`_SpinBase.apply_statevector`.
The Hamiltonian names the device that work runs on (``device=``).  On the
device a two-word configuration is one 64-bit channel (``ops/bits.join2``),
and its int64 key (top bit flipped) is the one-word machinery's, so the
Selected-CI scorer and the exact dE2 take it unchanged.  The full-2^n
statevector routes refuse more than 31 sites, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.bits import join2, split2
from .base import Hamiltonian

__all__ = ["HeisenbergHamiltonian", "TransverseFieldIsing",
           "create_heisenberg_hamiltonian", "create_tfim_hamiltonian",
           "extract_coeffs_and_paulis", "pack_spin_state",
           "spin_state_int"]

MAX_SPINS = 64


def _spin_words(n: int) -> int:
    """uint32 words per configuration: 1 for n <= 31, 2 for 32..64."""
    if n > MAX_SPINS:
        raise NotImplementedError(
            f"packed 2 x uint32 configurations support <= {MAX_SPINS} spins")
    return 1 if n <= 31 else 2


def pack_spin_state(x: int, n: int) -> np.ndarray:
    """Python-int spin configuration -> (W,) uint32 packed row."""
    if _spin_words(n) == 1:
        return np.array([x], np.uint32)
    return np.array([(x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF], np.uint32)


def spin_state_int(row: np.ndarray) -> int:
    """(W,) uint32 packed row -> Python-int spin configuration."""
    row = np.asarray(row).reshape(-1)
    if row.shape[0] == 1:
        return int(row[0])
    return (int(row[0]) << 32) | int(row[1])


def _site_mask(sites: Sequence[int], W: int) -> np.ndarray:
    """XOR mask (W,) uint32 flipping the given sites."""
    m = np.zeros(W, np.uint32)
    for s in sites:
        col = W - 1 - (s // 32)          # the low word is the last column
        m[col] |= np.uint32(1 << (s % 32))
    return m


def _bit_np(packed: np.ndarray, s: int) -> np.ndarray:
    """(B, W) uint32, site index -> (B,) uint32 occupation bit."""
    col = packed.shape[1] - 1 - (s // 32)
    return (packed[:, col] >> np.uint32(s % 32)) & np.uint32(1)


def _spins(packed: np.ndarray, n: int) -> np.ndarray:
    """(B, W) packed -> (B, n) {-1,+1} float64."""
    packed = np.atleast_2d(packed)
    shifts = np.arange(min(n, 32), dtype=np.uint32)
    bits = (packed[:, -1:] >> shifts) & 1
    if n > 32:
        shifts_hi = np.arange(n - 32, dtype=np.uint32)
        bits = np.concatenate([bits, (packed[:, 0:1] >> shifts_hi) & 1],
                              axis=1)
    return 2.0 * bits.astype(np.float64) - 1.0


def _full_space_sites(n: int) -> None:
    """The full-2^n statevector routes hold one word a state."""
    if n > 31:
        raise NotImplementedError(
            "full-2^n statevector routes require n <= 31 spins")


def _flip1(v: np.ndarray, i: int, n: int) -> np.ndarray:
    """``v`` reindexed with basis bit ``i`` flipped: one slab-swap copy
    (no index arrays)."""
    return v.reshape(1 << (n - 1 - i), 2, 1 << i)[:, ::-1, :].reshape(-1)


def _flip2_anti(v: np.ndarray, i: int, j: int, n: int) -> np.ndarray:
    """``v`` reindexed with bits ``i < j`` both flipped, zeroed wherever
    the output configuration is aligned at (i, j).

    This is the XXZ flip-flop stencil: output x receives v[x ^ mask] iff x
    (equivalently its source) is antiparallel on the bond, and alignment
    is invariant under the double flip."""
    a, b, c = 1 << (n - 1 - j), 1 << (j - 1 - i), 1 << i
    w = v.reshape(a, 2, b, 2, c)[:, ::-1, :, ::-1, :].copy()
    w[:, 0, :, 0, :] = 0.0
    w[:, 1, :, 1, :] = 0.0
    return w.reshape(-1)


def _flip1_device(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Device twin of :func:`_flip1`: a slab reshape and an axis reverse
    (``flip`` copies, so each call makes one new N-vector).  The JAX
    package's lane-permutation matmuls and rolls answer the TPU's (8, 128)
    tiling and have no counterpart here."""
    return v.view(1 << (n - 1 - i), 2, 1 << i).flip(1).reshape(-1)


def _flip2_anti_device(v: torch.Tensor, i: int, j: int, n: int
                       ) -> torch.Tensor:
    """Device twin of :func:`_flip2_anti` (``i < j``)."""
    a, b, c = 1 << (n - 1 - j), 1 << (j - 1 - i), 1 << i
    w = v.view(a, 2, b, 2, c).flip((1, 3))
    anti = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=v.dtype,
                        device=v.device).view(1, 2, 1, 2, 1)
    return (w * anti).reshape(-1)


class _SpinBase(Hamiltonian):
    pack_words = 1
    DEVICE_CACHES = {"_device_ops": None}

    def _init_common(self, num_spins: int, device) -> None:
        self.pack_words = _spin_words(num_spins)
        self.n_sites = num_spins
        self.device = torch.device(device)
        self._device_ops = None
        self._full_diag_np: Optional[np.ndarray] = None

    def exact_dense(self) -> np.ndarray:
        """Dense H over the full 2^n space (for n <= ~14; test oracle)."""
        _full_space_sites(self.n_sites)
        states = np.arange(1 << self.n_sites, dtype=np.uint32)[:, None]
        return self.matrix_elements(states, states)

    # -- device closures (float32 over int64 words) ------------------------

    def _ops(self):
        if self._device_ops is None:
            self._device_ops = _spin_device_ops(self)
        return self._device_ops

    def diagonal_device(self, packed: torch.Tensor) -> torch.Tensor:
        """(B, W) int64 words on ``self.device`` -> (B,) float32."""
        return self._ops()[0](packed)

    @property
    def connections_device(self):
        """f(packed (B, W) int64) -> ((B, C, W) int64, (B, C) float32) on
        ``self.device``; every configuration has the same C flip slots,
        a forbidden flip carrying a zero element."""
        return self._ops()[1]

    # -- host f64 full-space statevector application -----------------------
    #
    # An independent formulation of H (slab bit-flip reshapes, not the
    # packed connections): the host refine of the full-2^n eigensolves
    # (``postprocessing.eigensolver.exact_fullspace_ground_state``).

    def full_diagonal_np(self) -> np.ndarray:
        """f64 diagonal over the full 2^n space (chunked, cached)."""
        _full_space_sites(self.n_sites)
        if self._full_diag_np is None:
            dim = 1 << self.n_sites
            out = np.empty(dim, np.float64)
            step = 1 << 20
            for s in range(0, dim, step):
                states = np.arange(s, min(s + step, dim),
                                   dtype=np.uint32)[:, None]
                out[s:s + len(states)] = self.diagonal_np(states)
            self._full_diag_np = out
        return self._full_diag_np

    def apply_statevector_np(self, v: np.ndarray,
                             diag: Optional[np.ndarray] = None) -> np.ndarray:
        """H @ v over the full 2^n space, float64, on the host."""
        n = self.n_sites
        _full_space_sites(n)
        v = np.asarray(v, np.float64).reshape(-1)
        if v.shape[0] != (1 << n):
            raise ValueError(f"expected a full 2^{n} statevector")
        out = (self.full_diagonal_np() if diag is None else diag) * v
        self._apply_offdiag_np(v, out)
        return out

    def _apply_offdiag_np(self, v: np.ndarray, out: np.ndarray) -> None:
        raise NotImplementedError

    # -- device (f32) full-space statevector application --------------------
    #
    # The table-free route of the full-2^n eigensolves: the identity-basis
    # ELL tables cost 8 * C * 2^n bytes, the flips store nothing but the
    # vectors.

    def apply_statevector(self, v: torch.Tensor, diag: torch.Tensor
                          ) -> torch.Tensor:
        """H @ v over the full 2^n space on ``v``'s device (float32 slab
        bit flips).  ``diag`` is the (2^n,) float32 diagonal
        (``postprocessing.eigensolver.full_diagonal_device``)."""
        _full_space_sites(self.n_sites)
        return self._apply_offdiag(v, diag * v)

    def _apply_offdiag(self, v: torch.Tensor, out: torch.Tensor
                       ) -> torch.Tensor:
        raise NotImplementedError


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
        B, W = packed.shape
        conns = []
        elems = []
        # bond flips: element (Jx+Jy)/4 when antiparallel, else 0
        for i, j in self.bonds:
            anti = _bit_np(packed, i) != _bit_np(packed, j)
            conns.append(packed ^ _site_mask((i, j), W)[None, :])
            elems.append(np.where(anti, (self.Jx + self.Jy) / 4.0, 0.0))
        if self._has_x_field:
            for i in range(self.n_sites):
                conns.append(packed ^ _site_mask((i,), W)[None, :])
                elems.append(np.full(B, self.h_x[i] / 2.0))
        conn = np.stack(conns, axis=1)                  # (B, C, W)
        el = np.stack(elems, axis=1)
        return conn.astype(np.uint32), el

    def _apply_offdiag_np(self, v: np.ndarray, out: np.ndarray) -> None:
        n = self.n_sites
        jxy = (self.Jx + self.Jy) / 4.0
        if abs(jxy) > 1e-15:
            for i, j in self.bonds:
                lo, hi = (i, j) if i < j else (j, i)
                out += jxy * _flip2_anti(v, lo, hi, n)
        if self._has_x_field:
            for i in range(n):
                if abs(self.h_x[i]) > 1e-12:
                    out += (self.h_x[i] / 2.0) * _flip1(v, i, n)

    def _apply_offdiag(self, v: torch.Tensor, out: torch.Tensor
                       ) -> torch.Tensor:
        n = self.n_sites
        jxy = float((self.Jx + self.Jy) / 4.0)
        if abs(jxy) > 1e-15:
            for i, j in self.bonds:
                lo, hi = (i, j) if i < j else (j, i)
                out = out + jxy * _flip2_anti_device(v, lo, hi, n)
        if self._has_x_field:
            for i in range(n):
                hx = float(self.h_x[i])
                if abs(hx) > 1e-12:
                    out = out + (hx / 2.0) * _flip1_device(v, i, n)
        return out


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
        W = packed.shape[1]
        conns = [packed ^ _site_mask((i,), W)[None, :]
                 for i in range(self.n_sites)]
        conn = np.stack(conns, axis=1)                  # (B, C, W)
        el = np.full((packed.shape[0], self.n_sites), -self.h)
        return conn.astype(np.uint32), el

    def _apply_offdiag_np(self, v: np.ndarray, out: np.ndarray) -> None:
        n = self.n_sites
        acc = _flip1(v, 0, n)
        for i in range(1, n):
            acc += _flip1(v, i, n)
        out -= self.h * acc

    def _apply_offdiag(self, v: torch.Tensor, out: torch.Tensor
                       ) -> torch.Tensor:
        n = self.n_sites
        acc = _flip1_device(v, 0, n)
        for i in range(1, n):
            acc = acc + _flip1_device(v, i, n)
        return out - float(self.h) * acc


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


# ---------------------------------------------------------------------------
# Device closures: static-shape spin connections over int64 words
# ---------------------------------------------------------------------------

def _signed64(v: int) -> int:
    """A 64-bit pattern as the int64 value with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _spin_device_ops(ham):
    """(diagonal_fn, connections_fn) in torch for a spin H on
    ``ham.device``.  A configuration's W words become one int64 channel
    (the word itself at W = 1, ``join2`` at W = 2): per-site bit tests are
    shifts of it, flip masks are (C,) int64 tables XORed against the
    batch, and targets are split back into W words.  Elements are
    float32, words int64 (``ops/bits.py``)."""
    n = ham.n_sites
    W = _spin_words(n)
    dev = ham.device
    shifts = torch.arange(n, dtype=torch.int64, device=dev)

    def channel(packed):
        """(B, W) int64 words -> (B, 1) int64 channel."""
        return (packed[:, 0:1] if W == 1 else join2(packed)[:, None])

    def words(chan):
        """(B, C) int64 channels -> (B, C, W) int64 words."""
        return chan[..., None] if W == 1 else split2(chan)

    def spins_of(packed):
        """(B, W) int64 -> (B, n) float32 in {-1, +1}."""
        bits = (channel(packed) >> shifts) & 1
        return 2.0 * bits.to(torch.float32) - 1.0

    def masks_for(groups):
        """list of site tuples -> (C,) int64 XOR masks."""
        return torch.tensor([_signed64(sum(1 << s for s in g))
                             for g in groups],
                            dtype=torch.int64, device=dev)

    flip_masks = masks_for([(i,) for i in range(n)])

    if isinstance(ham, TransverseFieldIsing):
        edges = torch.tensor(np.array(ham.edges, np.int64).reshape(-1, 2),
                             device=dev)
        V, hf = float(ham.V), float(ham.h)

        def diagonal(packed):
            s = spins_of(packed)
            return -V * torch.sum(s[:, edges[:, 0]] * s[:, edges[:, 1]], -1)

        def connections(packed):
            conn = words(channel(packed) ^ flip_masks[None, :])
            elems = torch.full((packed.shape[0], n), -hf,
                               dtype=torch.float32, device=packed.device)
            return conn, elems

        return diagonal, connections

    if isinstance(ham, HeisenbergHamiltonian):
        Jz = float(ham.Jz)
        Jxy4 = float((ham.Jx + ham.Jy) / 4.0)
        hz = torch.tensor(ham.h_z, dtype=torch.float32, device=dev)
        hx = torch.tensor(ham.h_x, dtype=torch.float32, device=dev)
        has_x = ham._has_x_field
        bonds_np = np.array(ham.bonds, np.int64).reshape(-1, 2)
        bonds = torch.tensor(bonds_np, device=dev)
        bond_masks = masks_for([tuple(b) for b in bonds_np])

        def diagonal(packed):
            s = spins_of(packed)
            zz = Jz / 4.0 * torch.sum(s[:, bonds[:, 0]] * s[:, bonds[:, 1]],
                                      -1)
            return zz + torch.sum(s * (hz / 2.0)[None, :], -1)

        def connections(packed):
            word = channel(packed)
            bi = (word >> bonds[None, :, 0]) & 1
            bj = (word >> bonds[None, :, 1]) & 1
            el_b = (bi != bj).to(torch.float32) * Jxy4
            conn_b = word ^ bond_masks[None, :]
            if has_x:
                conn_x = word ^ flip_masks[None, :]
                el_x = (hx / 2.0)[None, :].expand(packed.shape[0], n)
                return (words(torch.cat([conn_b, conn_x], 1)),
                        torch.cat([el_b, el_x], 1))
            return words(conn_b), el_b

        return diagonal, connections

    raise TypeError(f"no device closures for {type(ham)}")
