"""Restricted Hartree-Fock and MO-basis integral transformation (host-side).

Behavioral counterpart of the reference's PySCF usage
(its ``hamiltonians/molecular.py:963-998``): run RHF, then
return MO-basis h1e = C^T h C and the chemist-notation 4-index ERI tensor.
Everything is float64 NumPy on the host; results ship to the device as
tensors.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .basis import (build_shells, is_spherical_basis, nuclear_charges,
                    nuclear_repulsion)
from .integrals import (eri_tensor, expand_shells, kinetic_matrix,
                        nuclear_attraction_matrix, overlap_matrix)

__all__ = ["MolecularIntegrals", "compute_molecular_integrals", "run_rhf",
           "run_rohf"]


@dataclass
class MolecularIntegrals:
    """MO-basis integrals; mirrors ``molecular.py:22-33`` in the reference."""
    h1e: np.ndarray               # (n, n) one-body MO integrals
    h2e: np.ndarray               # (n, n, n, n) chemist-notation (pq|rs)
    nuclear_repulsion: float
    n_electrons: int
    n_orbitals: int
    n_alpha: int
    n_beta: int
    hf_energy: Optional[float] = None
    mo_energies: Optional[np.ndarray] = None


def run_rhf(S: np.ndarray, Hcore: np.ndarray, eri: np.ndarray,
            n_occ: int, e_nuc: float,
            max_cycles: int = 200, conv_tol: float = 1e-11,
            ) -> Tuple[float, np.ndarray, np.ndarray]:
    """RHF with DIIS. Returns (E_total, C, mo_energies)."""
    s_vals, s_vecs = np.linalg.eigh(S)
    keep = s_vals > 1e-10
    X = s_vecs[:, keep] / np.sqrt(s_vals[keep])

    def solve_fock(F):
        Fp = X.T @ F @ X
        eps, Cp = np.linalg.eigh(Fp)
        return eps, X @ Cp

    eps, C = solve_fock(Hcore)
    D = 2.0 * C[:, :n_occ] @ C[:, :n_occ].T

    fock_list: List[np.ndarray] = []
    err_list: List[np.ndarray] = []
    E_old = 0.0
    for _ in range(max_cycles):
        J = np.einsum("pqrs,rs->pq", eri, D, optimize=True)
        K = np.einsum("prqs,rs->pq", eri, D, optimize=True)
        F = Hcore + J - 0.5 * K
        E = 0.5 * np.sum(D * (Hcore + F)) + e_nuc

        # DIIS
        err = F @ D @ S - S @ D @ F
        fock_list.append(F)
        err_list.append(err)
        if len(fock_list) > 8:
            fock_list.pop(0)
            err_list.pop(0)
        if len(fock_list) > 1:
            m = len(fock_list)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            for i in range(m):
                for j in range(m):
                    B[i, j] = np.sum(err_list[i] * err_list[j])
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(B, rhs)[:m]
                F = sum(wi * Fi for wi, Fi in zip(w, fock_list))
            except np.linalg.LinAlgError:
                pass

        eps, C = solve_fock(F)
        D = 2.0 * C[:, :n_occ] @ C[:, :n_occ].T
        if abs(E - E_old) < conv_tol and np.max(np.abs(err)) < 1e-7:
            break
        E_old = E
    return float(E), C, eps


def run_rohf(S: np.ndarray, Hcore: np.ndarray, eri: np.ndarray,
             n_alpha: int, n_beta: int, e_nuc: float,
             max_cycles: int = 300, conv_tol: float = 1e-10,
             level_shift: float = 0.0,
             ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Restricted open-shell HF (Guest-Saunders effective Fock) with DIIS
    and optional virtual-orbital level shifting.

    Counterpart of the reference's ``scf.ROHF`` path
    (``molecular.py:978-981``).  Returns (E_total, C, mo_energies);
    n_alpha >= n_beta (alpha carries the open shell).  ``level_shift``
    raises virtuals during early iterations (decayed once DIIS bites) —
    needed for transition-metal systems where the core guess starts far
    from the Aufbau configuration.
    """
    assert n_alpha >= n_beta
    s_vals, s_vecs = np.linalg.eigh(S)
    keep = s_vals > 1e-10
    X = s_vecs[:, keep] / np.sqrt(s_vals[keep])

    def solve(F):
        eps, Cp = np.linalg.eigh(X.T @ F @ X)
        return eps, X @ Cp

    eps, C = solve(Hcore)
    E_old = 0.0
    best = (np.inf, C, eps)
    fock_list: List[np.ndarray] = []
    err_list: List[np.ndarray] = []
    for cycle in range(max_cycles):
        Ca = C[:, :n_alpha]
        Cb = C[:, :n_beta]
        Da = Ca @ Ca.T
        Db = Cb @ Cb.T
        Dt = Da + Db
        J = np.einsum("pqrs,rs->pq", eri, Dt, optimize=True)
        Ka = np.einsum("prqs,rs->pq", eri, Da, optimize=True)
        Kb = np.einsum("prqs,rs->pq", eri, Db, optimize=True)
        Fa = Hcore + J - Ka
        Fb = Hcore + J - Kb
        E = (0.5 * np.sum(Da * (Hcore + Fa))
             + 0.5 * np.sum(Db * (Hcore + Fb)) + e_nuc)

        # Guest-Saunders effective Fock in the current MO basis
        Fa_mo = C.T @ Fa @ C
        Fb_mo = C.T @ Fb @ C
        n = C.shape[1]
        R = 0.5 * (Fa_mo + Fb_mo)
        c_idx = slice(0, n_beta)            # doubly occupied
        o_idx = slice(n_beta, n_alpha)      # singly occupied (alpha)
        v_idx = slice(n_alpha, n)           # virtual
        R[c_idx, o_idx] = Fb_mo[c_idx, o_idx]
        R[o_idx, c_idx] = Fb_mo[o_idx, c_idx]
        R[o_idx, v_idx] = Fa_mo[o_idx, v_idx]
        R[v_idx, o_idx] = Fa_mo[v_idx, o_idx]
        R = 0.5 * (R + R.T)

        # effective Fock back in the AO basis for DIIS extrapolation
        # (C^T S C = I  =>  C^{-1} = C^T S)
        SC = S @ C
        F_eff = SC @ R @ SC.T
        err = F_eff @ Dt @ S - S @ Dt @ F_eff
        err_norm = np.max(np.abs(err))
        fock_list.append(F_eff)
        err_list.append(err)
        if len(fock_list) > 8:
            fock_list.pop(0)
            err_list.pop(0)
        if len(fock_list) > 1:
            m = len(fock_list)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            for i in range(m):
                for j in range(m):
                    B[i, j] = np.sum(err_list[i] * err_list[j])
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(B, rhs)[:m]
                F_eff = sum(wi * Fi for wi, Fi in zip(w, fock_list))
            except np.linalg.LinAlgError:
                pass

        if level_shift > 0.0 and err_norm > 1e-3:
            # raise current virtuals to keep the Aufbau occupation stable
            F_eff = F_eff + level_shift * (SC[:, n_alpha:]
                                           @ SC[:, n_alpha:].T)
        eps, C = solve(F_eff)
        if E < best[0] and err_norm < 1e-5:
            best = (E, C, eps)
        if abs(E - E_old) < conv_tol and err_norm < 1e-7 and cycle > 2:
            break
        E_old = E
    if best[0] < E - 1e-9:
        # a lower converged solution was seen earlier (occupation flip)
        E, C, eps = best
        return float(E), C, eps
    return float(E), C, eps


def _cart2sph_transform(shells, S_cart: np.ndarray) -> np.ndarray:
    """(n_sph, n_cart) projector onto real solid harmonics.

    s/p shells pass through; each Cartesian-d block (xx, yy, zz, xy, xz,
    yz — the expand_shells order) maps to the 5 spherical d functions,
    dropping the totally-symmetric (s-contaminant) combination.  Rows are
    normalized numerically against the Cartesian overlap, so no analytic
    double-factorial bookkeeping is needed.
    """
    blocks = []
    col = 0
    for sh in shells:
        if sh.l == 0:
            blocks.append((col, np.ones((1, 1))))
            col += 1
        elif sh.l == 1:
            blocks.append((col, np.eye(3)))
            col += 3
        elif sh.l == 2:
            V = np.zeros((5, 6))
            V[0, 0], V[0, 1], V[0, 2] = -1.0, -1.0, 2.0   # d_z2
            V[1, 0], V[1, 1] = 1.0, -1.0                   # d_x2-y2
            V[2, 3] = 1.0                                  # d_xy
            V[3, 4] = 1.0                                  # d_xz
            V[4, 5] = 1.0                                  # d_yz
            Sb = S_cart[col:col + 6, col:col + 6]
            for r in range(5):
                V[r] /= np.sqrt(V[r] @ Sb @ V[r])
            blocks.append((col, V))
            col += 6
        else:
            raise NotImplementedError(f"l={sh.l} in spherical transform")
    n_cart = col
    n_sph = sum(b.shape[0] for _, b in blocks)
    T = np.zeros((n_sph, n_cart))
    row = 0
    for c0, b in blocks:
        T[row:row + b.shape[0], c0:c0 + b.shape[1]] = b
        row += b.shape[0]
    return T


def _transform_to_mo(Hcore: np.ndarray, eri: np.ndarray, C: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    h1 = C.T @ Hcore @ C
    # quarter transforms, O(n^5)
    tmp = np.einsum("pqrs,pi->iqrs", eri, C, optimize=True)
    tmp = np.einsum("iqrs,qj->ijrs", tmp, C, optimize=True)
    tmp = np.einsum("ijrs,rk->ijks", tmp, C, optimize=True)
    h2 = np.einsum("ijks,sl->ijkl", tmp, C, optimize=True)
    return h1, h2


# bump when tabulated basis data or the SCF procedure changes, so stale
# cached integrals are not reused (round 2: published second-row STO-3G,
# Li/F 6-31G, cc-pVDZ, Fe, spherical-d, ROHF DIIS/level-shift)
_BASIS_DATA_VERSION = "v2"


def _geometry_key(geometry, basis: str, charge: int, spin: int) -> str:
    parts = [_BASIS_DATA_VERSION, basis, str(charge), str(spin)]
    for el, xyz in geometry:
        parts.append(el)
        parts.extend(f"{v:.10f}" for v in xyz)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]


def compute_molecular_integrals(
    geometry: Sequence[Tuple[str, Tuple[float, float, float]]],
    basis: str = "sto-3g",
    charge: int = 0,
    spin: int = 0,
    cache_dir: Optional[str] = None,
) -> MolecularIntegrals:
    """Drop-in equivalent of the reference's PySCF wrapper.

    Geometry is in Angstrom; ``spin`` is 2S: 0 -> RHF, >0 -> ROHF with
    ``spin`` unpaired alpha electrons (the reference's routing,
    ``molecular.py:976-981``).
    """

    if cache_dir is None:
        cache_dir = os.environ.get(
            "FGK_INTEGRAL_CACHE",
            os.path.join(os.path.expanduser("~"), ".cache", "fgk_tpu_integrals"))
    key = _geometry_key(geometry, basis, charge, spin)
    cache_path = os.path.join(cache_dir, f"{key}.npz")
    if os.path.exists(cache_path):
        data = np.load(cache_path)
        return MolecularIntegrals(
            h1e=data["h1e"], h2e=data["h2e"],
            nuclear_repulsion=float(data["e_nuc"]),
            n_electrons=int(data["n_elec"]), n_orbitals=int(data["n_orb"]),
            n_alpha=int(data["n_alpha"]), n_beta=int(data["n_beta"]),
            hf_energy=float(data["e_hf"]), mo_energies=data["mo_energies"])

    shells = build_shells(geometry, basis)
    funcs = expand_shells(shells)
    charges, coords = nuclear_charges(geometry)
    e_nuc = nuclear_repulsion(geometry)

    S = overlap_matrix(funcs)
    T = kinetic_matrix(funcs)
    V = nuclear_attraction_matrix(funcs, charges, coords)
    Hcore = T + V
    eri = eri_tensor(funcs)

    if is_spherical_basis(basis):
        # project d shells onto the 5 real solid harmonics (the published
        # convention for Dunning bases; PySCF default)
        Tr = _cart2sph_transform(shells, S)
        S = Tr @ S @ Tr.T
        Hcore = Tr @ Hcore @ Tr.T
        eri = np.einsum("pqrs,ip->iqrs", eri, Tr, optimize=True)
        eri = np.einsum("iqrs,jq->ijrs", eri, Tr, optimize=True)
        eri = np.einsum("ijrs,kr->ijks", eri, Tr, optimize=True)
        eri = np.einsum("ijks,ls->ijkl", eri, Tr, optimize=True)

    n_electrons = int(np.sum(charges)) - charge
    if (n_electrons - spin) % 2 != 0:
        raise ValueError(
            f"electron count {n_electrons} inconsistent with spin={spin}")
    n_alpha = (n_electrons + spin) // 2
    n_beta = (n_electrons - spin) // 2

    if spin == 0:
        e_hf, C, eps = run_rhf(S, Hcore, eri, n_alpha, e_nuc)
    else:
        # transition-metal systems start far from Aufbau under the core
        # guess; level shifting keeps the occupation from flipping
        shift = 1.0 if any(el in ("Fe", "Cr") for el, _ in geometry) else 0.0
        e_hf, C, eps = run_rohf(S, Hcore, eri, n_alpha, n_beta, e_nuc,
                                level_shift=shift)
    h1, h2 = _transform_to_mo(Hcore, eri, C)

    result = MolecularIntegrals(
        h1e=h1, h2e=h2, nuclear_repulsion=e_nuc,
        n_electrons=n_electrons, n_orbitals=h1.shape[0],
        n_alpha=n_alpha, n_beta=n_beta,
        hf_energy=e_hf, mo_energies=eps)

    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(
            cache_path, h1e=h1, h2e=h2, e_nuc=e_nuc, n_elec=n_electrons,
            n_orb=h1.shape[0], n_alpha=n_alpha, n_beta=n_beta, e_hf=e_hf,
            mo_energies=eps)
    except OSError:
        pass
    return result
