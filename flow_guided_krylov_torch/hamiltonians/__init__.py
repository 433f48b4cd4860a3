"""Hamiltonians over packed determinants and spin configurations."""

from .base import Hamiltonian, PauliString
from .molecular import (MOLECULE_FACTORIES, MolecularHamiltonian,
                        MolecularIntegrals, create_beh2_hamiltonian,
                        create_ch4_hamiltonian, create_h2_hamiltonian,
                        create_h2o_hamiltonian, create_lih_hamiltonian,
                        create_n2_hamiltonian, create_nh3_hamiltonian,
                        create_synthetic_hamiltonian, synthetic_integrals)
from .spin import (HeisenbergHamiltonian, TransverseFieldIsing,
                   create_heisenberg_hamiltonian, create_tfim_hamiltonian,
                   extract_coeffs_and_paulis, pack_spin_state, spin_state_int)

__all__ = [
    "Hamiltonian", "PauliString", "MolecularIntegrals", "MolecularHamiltonian",
    "MOLECULE_FACTORIES",
    "create_h2_hamiltonian", "create_lih_hamiltonian",
    "create_h2o_hamiltonian", "create_beh2_hamiltonian",
    "create_nh3_hamiltonian", "create_n2_hamiltonian",
    "create_ch4_hamiltonian",
    "synthetic_integrals", "create_synthetic_hamiltonian",
    "HeisenbergHamiltonian", "TransverseFieldIsing",
    "create_heisenberg_hamiltonian", "create_tfim_hamiltonian",
    "extract_coeffs_and_paulis", "pack_spin_state", "spin_state_int",
]
