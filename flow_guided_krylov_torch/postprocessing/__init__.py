"""Host eigensolvers for projected subspace Hamiltonians."""

from .eigensolver import DavidsonSolver

__all__ = ["DavidsonSolver"]
