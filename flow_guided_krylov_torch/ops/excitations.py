"""Static excitation enumeration tables (host NumPy).

Counterpart of ``flow_guided_krylov_tpu/ops/excitations.py``.  For fixed
(n_orb, n_alpha, n_beta) every particle-conserving determinant has the same
number of single and double excitations, so connection enumeration is a
static-shaped batched gather.  Grids index into per-determinant ascending
occupied/virtual orbital lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from math import comb

import numpy as np

__all__ = ["ExcitationSpec", "build_excitation_spec", "connection_count"]


@dataclass(frozen=True)
class ExcitationSpec:
    """Index grids for one spin channel with k occupied of n orbitals."""
    n_orb: int
    k: int
    # singles: (n_single, 2) -> (occ_idx, vir_idx)
    singles: np.ndarray
    # same-spin doubles: (n_double, 4) -> (occ_i, occ_j, vir_a, vir_b), i<j, a<b
    doubles: np.ndarray

    @property
    def n_single(self) -> int:
        return self.singles.shape[0]

    @property
    def n_double(self) -> int:
        return self.doubles.shape[0]


def build_excitation_spec(n_orb: int, k: int) -> ExcitationSpec:
    n_vir = n_orb - k
    singles = np.array(
        [(i, a) for i in range(k) for a in range(n_vir)],
        dtype=np.int32).reshape(k * n_vir, 2)
    occ_pairs = list(combinations(range(k), 2))
    vir_pairs = list(combinations(range(n_vir), 2))
    doubles = np.array(
        [(i, j, a, b) for (i, j) in occ_pairs for (a, b) in vir_pairs],
        dtype=np.int32).reshape(len(occ_pairs) * len(vir_pairs), 4)
    return ExcitationSpec(n_orb=n_orb, k=k, singles=singles, doubles=doubles)


def connection_count(n_orb: int, n_alpha: int, n_beta: int) -> int:
    """Total connections per determinant (singles + doubles, both spins)."""
    sa = n_alpha * (n_orb - n_alpha)
    sb = n_beta * (n_orb - n_beta)
    daa = comb(n_alpha, 2) * comb(n_orb - n_alpha, 2)
    dbb = comb(n_beta, 2) * comb(n_orb - n_beta, 2)
    dab = sa * sb
    return sa + sb + daa + dbb + dab
