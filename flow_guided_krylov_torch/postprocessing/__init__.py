"""Host eigensolvers, the DMRG oracle, stage-2 basis selection, the
Pauli-word projected Hamiltonian and the basis bookkeeping utilities."""

from .diversity_selection import (DiversityConfig, DiversitySelector,
                                  ExcitationBucketer, analyze_basis_diversity,
                                  compute_excitation_rank,
                                  compute_hamming_distance_matrix,
                                  select_diverse_basis)
from .dmrg import dmrg_ground_state
from .eigensolver import (DavidsonSolver, adaptive_eigensolver,
                          exact_fullspace_ground_state, lanczos_ground_state,
                          regularize_overlap_matrix,
                          solve_generalized_eigenvalue)
from .projected_hamiltonian import (ProjectedHamiltonianBuilder,
                                    ProjectedHamiltonianConfig)
from .utils import (basis_overlap, bitstring_to_int, filter_by_probability,
                    ground_state_sparsity, int_to_bitstring, merge_bases,
                    merge_measurements)

__all__ = [
    "DavidsonSolver", "DiversityConfig", "DiversitySelector",
    "ExcitationBucketer", "compute_excitation_rank",
    "compute_hamming_distance_matrix", "select_diverse_basis",
    "analyze_basis_diversity",
    "dmrg_ground_state", "solve_generalized_eigenvalue",
    "regularize_overlap_matrix", "adaptive_eigensolver",
    "lanczos_ground_state", "exact_fullspace_ground_state",
    "ProjectedHamiltonianBuilder", "ProjectedHamiltonianConfig",
    "bitstring_to_int", "int_to_bitstring", "merge_measurements",
    "filter_by_probability", "basis_overlap", "ground_state_sparsity",
    "merge_bases",
]
