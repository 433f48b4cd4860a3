"""Selected-CI expansion (stage 3), SKQD (stage 4) and circuit basis
sampling."""

from .basis_sampler import (CircuitSamplerConfig, CUDAQConfig,
                            KrylovBasisSampler, create_circuit_sampler)
from .residual_expansion import (ResidualBasedExpander,
                                 ResidualExpansionConfig, SelectedCIExpander,
                                 iterative_residual_expansion)
from .skqd import (EvolutionBudgetError, FlowGuidedSKQD,
                   SampleBasedKrylovDiagonalization, SKQDConfig, lanczos_expm,
                   lanczos_expm_ell, supported_evolution_dim)

__all__ = [
    "ResidualExpansionConfig", "SelectedCIExpander",
    "ResidualBasedExpander", "iterative_residual_expansion",
    "SKQDConfig", "SampleBasedKrylovDiagonalization", "FlowGuidedSKQD",
    "EvolutionBudgetError", "lanczos_expm", "lanczos_expm_ell",
    "supported_evolution_dim",
    "CircuitSamplerConfig", "CUDAQConfig", "KrylovBasisSampler",
    "create_circuit_sampler",
]
