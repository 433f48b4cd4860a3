"""Active-space (frozen-core) effective integrals.

The port's copy of the JAX package's ``chem/active_space.py``: freeze the
lowest ``n_frozen`` (doubly occupied) MOs and fold their Coulomb/exchange
field into the one-body integrals of an active MO window:

    E_core   = 2 sum_i h_ii + sum_ij (2 (ii|jj) - (ij|ji))      i,j frozen
    h_eff_pq = h_pq + sum_i (2 (pq|ii) - (pi|iq))               i frozen
    h2_act   = (pq|rs) restricted to the active window

Everything stays host-side float64.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .scf import MolecularIntegrals, compute_molecular_integrals

__all__ = ["compute_active_space_integrals", "active_space_from_molecule"]


def compute_active_space_integrals(
    integrals: MolecularIntegrals,
    n_frozen: int,
    n_active: Optional[int] = None,
) -> MolecularIntegrals:
    """Fold frozen-core contributions into an active-window Hamiltonian."""
    h1 = np.asarray(integrals.h1e, np.float64)
    h2 = np.asarray(integrals.h2e, np.float64)
    n_orb = integrals.n_orbitals
    if n_active is None:
        n_active = n_orb - n_frozen
    if n_frozen + n_active > n_orb:
        raise ValueError(
            f"frozen({n_frozen}) + active({n_active}) > orbitals({n_orb})")
    frozen = np.arange(n_frozen)
    active = np.arange(n_frozen, n_frozen + n_active)

    # core energy
    e_core = 2.0 * h1[frozen, frozen].sum()
    if n_frozen:
        jij = h2[np.ix_(frozen, frozen, frozen, frozen)]
        # (ii|jj) and (ij|ji)
        coul = np.einsum("iijj->", jij)
        exch = np.einsum("ijji->", jij)
        e_core += 2.0 * coul - exch

    # effective one-body in the active window
    h1_act = h1[np.ix_(active, active)].copy()
    if n_frozen:
        # sum_i 2 (pq|ii)
        coul_f = 2.0 * np.einsum(
            "pqii->pq", h2[np.ix_(active, active, frozen, frozen)])
        # sum_i (pi|iq)
        exch_f = np.einsum(
            "piiq->pq", h2[np.ix_(active, frozen, frozen, active)])
        h1_act += coul_f - exch_f

    h2_act = h2[np.ix_(active, active, active, active)].copy()

    n_elec_active = integrals.n_electrons - 2 * n_frozen
    n_alpha = integrals.n_alpha - n_frozen
    n_beta = integrals.n_beta - n_frozen
    if min(n_elec_active, n_alpha, n_beta) < 0:
        raise ValueError("more frozen orbitals than occupied pairs")

    return MolecularIntegrals(
        h1e=h1_act, h2e=h2_act,
        nuclear_repulsion=float(integrals.nuclear_repulsion + e_core),
        n_electrons=n_elec_active, n_orbitals=n_active,
        n_alpha=n_alpha, n_beta=n_beta,
        hf_energy=integrals.hf_energy,
        mo_energies=(integrals.mo_energies[active]
                     if integrals.mo_energies is not None else None))


def active_space_from_molecule(
    geometry: Sequence[Tuple[str, Tuple[float, float, float]]],
    n_frozen: int, n_active: Optional[int] = None,
    basis: str = "sto-3g", charge: int = 0,
) -> MolecularIntegrals:
    """Convenience: full integrals then active-space folding."""
    ints = compute_molecular_integrals(geometry, basis=basis, charge=charge)
    return compute_active_space_integrals(ints, n_frozen, n_active)
