"""Selected-CI expansion (stage 3) and SKQD (stage 4)."""

from .residual_expansion import (ResidualExpansionConfig, SelectedCIExpander,
                                 iterative_residual_expansion)
from .skqd import (EvolutionBudgetError, FlowGuidedSKQD,
                   SampleBasedKrylovDiagonalization, SKQDConfig, lanczos_expm,
                   lanczos_expm_ell)

__all__ = [
    "ResidualExpansionConfig", "SelectedCIExpander",
    "iterative_residual_expansion",
    "SKQDConfig", "SampleBasedKrylovDiagonalization", "FlowGuidedSKQD",
    "EvolutionBudgetError", "lanczos_expm", "lanczos_expm_ell",
]
