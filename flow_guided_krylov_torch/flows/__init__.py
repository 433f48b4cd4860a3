"""The stage-1 flows and trainers: the particle-conserving flow and its
trainers for molecules (the local-energy ``PhysicsGuidedFlowTrainer`` and
the subspace-energy ``FlowNQSTrainer``); the S_z-conserving and the
discrete (RealNVP) flow and the spin trainer for spin systems."""

from .discrete import DiscreteFlowSampler, MultiModalPrior
from .particle_conserving import (GumbelTopK, OrbitalScoringNetwork,
                                  ParticleConservingFlow,
                                  ParticleConservingFlowSampler,
                                  SzConservingFlow, gumbel_topk,
                                  verify_particle_conservation)
from .physics_guided_training import (PhysicsGuidedConfig,
                                      PhysicsGuidedFlowTrainer)
from .spin_training import SpinFlowTrainer
from .training import (FlowNQSTrainer, IncrementalHamiltonianCache,
                       InferenceNQSTrainer, TrainingConfig)

__all__ = [
    "ParticleConservingFlow", "ParticleConservingFlowSampler", "gumbel_topk",
    "GumbelTopK", "OrbitalScoringNetwork", "verify_particle_conservation",
    "PhysicsGuidedConfig", "PhysicsGuidedFlowTrainer", "SpinFlowTrainer",
    "DiscreteFlowSampler", "MultiModalPrior", "SzConservingFlow",
    "TrainingConfig", "FlowNQSTrainer", "InferenceNQSTrainer",
    "IncrementalHamiltonianCache",
]
