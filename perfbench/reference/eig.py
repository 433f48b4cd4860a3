"""Lowest eigenvalue of a symmetric sparse matrix, in a stated precision."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

__all__ = ["ground_energy"]


def ground_energy(H: sp.spmatrix, dtype=np.float64) -> float:
    """Lowest eigenvalue of H, symmetrized and solved in ``dtype``:
    float64 is the reference; float32 is the benchmark's control."""
    H = sp.csr_matrix((H + H.T) * 0.5).astype(dtype)
    n = H.shape[0]
    if n <= 1500:
        return float(np.linalg.eigvalsh(H.toarray())[0])
    tol = 0.0 if dtype == np.float64 else 1e-6
    v0 = np.ones(n, dtype) / np.sqrt(n)
    return float(spla.eigsh(H, k=1, which="SA", v0=v0, tol=tol,
                            return_eigenvectors=False)[0])
