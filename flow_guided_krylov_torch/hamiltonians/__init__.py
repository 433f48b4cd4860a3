"""Hamiltonians over packed determinants."""

from .base import Hamiltonian
from .molecular import (MOLECULE_FACTORIES, MolecularHamiltonian,
                        MolecularIntegrals, create_beh2_hamiltonian,
                        create_ch4_hamiltonian, create_h2_hamiltonian,
                        create_h2o_hamiltonian, create_lih_hamiltonian,
                        create_n2_hamiltonian, create_nh3_hamiltonian,
                        create_synthetic_hamiltonian, synthetic_integrals)

__all__ = [
    "Hamiltonian", "MolecularIntegrals", "MolecularHamiltonian",
    "MOLECULE_FACTORIES",
    "create_h2_hamiltonian", "create_lih_hamiltonian",
    "create_h2o_hamiltonian", "create_beh2_hamiltonian",
    "create_nh3_hamiltonian", "create_n2_hamiltonian",
    "create_ch4_hamiltonian",
    "synthetic_integrals", "create_synthetic_hamiltonian",
]
