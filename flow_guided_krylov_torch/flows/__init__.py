"""The stage-1 flows and trainers: the particle-conserving flow and its
trainer for molecules; the S_z-conserving and the discrete (RealNVP) flow
and the spin trainer for spin systems."""

from .discrete import DiscreteFlowSampler, MultiModalPrior
from .particle_conserving import (ParticleConservingFlow, SzConservingFlow,
                                  gumbel_topk, verify_particle_conservation)
from .physics_guided_training import (PhysicsGuidedConfig,
                                      PhysicsGuidedFlowTrainer)
from .spin_training import SpinFlowTrainer

__all__ = ["ParticleConservingFlow", "SzConservingFlow", "gumbel_topk",
           "verify_particle_conservation", "DiscreteFlowSampler",
           "MultiModalPrior", "PhysicsGuidedConfig",
           "PhysicsGuidedFlowTrainer", "SpinFlowTrainer"]
