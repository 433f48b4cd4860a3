"""Selected-CI expansion (stage 3), SKQD (stage 4) and circuit basis
sampling."""

from .basis_sampler import (CircuitSamplerConfig, KrylovBasisSampler,
                            create_circuit_sampler)
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
    "CircuitSamplerConfig", "KrylovBasisSampler", "create_circuit_sampler",
]
