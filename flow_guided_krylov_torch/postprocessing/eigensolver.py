"""Host float64 Davidson eigensolver.

Copy of ``flow_guided_krylov_tpu/postprocessing/eigensolver.py::
DavidsonSolver``, whose module imports JAX at load and so cannot be
imported where JAX is absent.  Final projected-Hamiltonian eigensolves
stay float64 on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["DavidsonSolver"]


class DavidsonSolver:
    """Davidson iteration for the lowest eigenpair of a large symmetric H."""

    def __init__(self, max_subspace: int = 30, max_iterations: int = 200,
                 tol: float = 1e-9):
        self.max_subspace = max_subspace
        self.max_iterations = max_iterations
        self.tol = tol
        # post-solve diagnostics (callers use these to decide fallback)
        self.converged = False
        self.n_matvecs = 0
        self.final_residual = np.inf

    def solve(self, matvec: Callable[[np.ndarray], np.ndarray],
              diagonal: np.ndarray, k: int = 1,
              v0: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """The subspace lives in preallocated (n, max_subspace) buffers,
        and the Gram matrix T = V^T W grows by one row and column per
        iteration (H is symmetric, so one new column determines both)."""
        n = len(diagonal)
        self.converged = False
        self.n_matvecs = 1
        if v0 is None:
            v0 = np.zeros(n)
            v0[int(np.argmin(diagonal))] = 1.0
        ms = self.max_subspace
        V = np.empty((n, ms), np.float64, order="F")
        W = np.empty((n, ms), np.float64, order="F")
        T = np.zeros((ms, ms))
        V[:, 0] = v0 / np.linalg.norm(v0)
        W[:, 0] = matvec(V[:, 0])
        T[0, 0] = V[:, 0] @ W[:, 0]
        theta = float(T[0, 0])
        x = V[:, 0]
        m = 1

        for _ in range(self.max_iterations):
            vals, vecs = np.linalg.eigh(T[:m, :m])
            theta = vals[0]
            y = vecs[:, 0]
            x = V[:, :m] @ y
            r = W[:, :m] @ y - theta * x
            rnorm = np.linalg.norm(r)
            self.final_residual = float(rnorm)
            if rnorm < self.tol:
                self.converged = True
                break
            # diagonal preconditioner
            denom = diagonal - theta
            denom = np.where(np.abs(denom) < 1e-8,
                             np.sign(denom + 1e-30) * 1e-8, denom)
            t = -r / denom
            # orthogonalize against V (twice, for stability)
            t = t - V[:, :m] @ (V[:, :m].T @ t)
            t = t - V[:, :m] @ (V[:, :m].T @ t)
            tn = np.linalg.norm(t)
            if tn < 1e-12:
                break
            t = t / tn
            if m >= ms:
                # collapse subspace to current best Ritz vector
                V[:, 0] = x / np.linalg.norm(x)
                W[:, 0] = matvec(V[:, 0])
                T[0, 0] = V[:, 0] @ W[:, 0]
                m = 1
                self.n_matvecs += 1
                continue
            V[:, m] = t
            W[:, m] = matvec(t)
            c = V[:, :m + 1].T @ W[:, m]
            T[:m + 1, m] = c
            T[m, :m + 1] = c
            m += 1
            self.n_matvecs += 1
        return np.array([theta]), x[:, None]
