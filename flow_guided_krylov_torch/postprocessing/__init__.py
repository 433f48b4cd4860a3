"""Host eigensolvers, the DMRG oracle and stage-2 basis selection."""

from .diversity_selection import DiversityConfig, DiversitySelector
from .dmrg import dmrg_ground_state
from .eigensolver import DavidsonSolver

__all__ = ["DavidsonSolver", "DiversityConfig", "DiversitySelector",
           "dmrg_ground_state"]
