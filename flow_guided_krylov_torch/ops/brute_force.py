"""Brute-force second-quantized Hamiltonian construction (test oracle).

Builds the dense Hamiltonian in the full 2^(2n) Fock space by sequentially
applying creation/annihilation operators to bitstrings — slow, simple and
independent of the Slater-Condon kernels, so it serves as the exactness
oracle for them.  A copy of the JAX package's ``ops/brute_force.py``; a
test oracle, imported by nothing on a device path.

Spin-orbital ordering: alpha p -> qubit p, beta p -> qubit n + p.

H = sum_{pq,s} h1[p,q] a+_{ps} a_{qs}
  + 1/2 sum_{pqrs,st} (pq|rs) a+_{ps} a+_{rt} a_{st} a_{qs'}   (chemist)
"""

from __future__ import annotations

import numpy as np

__all__ = ["dense_hamiltonian_fock", "apply_annihilate", "apply_create"]


def _parity_below(state: int, orb: int) -> int:
    mask = (1 << orb) - 1
    return 1 - 2 * (bin(state & mask).count("1") & 1)


def apply_annihilate(state: int, orb: int):
    """a_orb |state>; returns (new_state, sign) or None."""
    if not (state >> orb) & 1:
        return None
    return state ^ (1 << orb), _parity_below(state, orb)


def apply_create(state: int, orb: int):
    """a+_orb |state>; returns (new_state, sign) or None."""
    if (state >> orb) & 1:
        return None
    return state ^ (1 << orb), _parity_below(state, orb)


def dense_hamiltonian_fock(h1: np.ndarray, h2: np.ndarray,
                           e_nuc: float) -> np.ndarray:
    """Dense H over the full 2^(2n) Fock space (use only for n <= 4)."""
    n = h1.shape[0]
    dim = 1 << (2 * n)
    H = np.zeros((dim, dim))
    spins = (0, n)  # offset of each spin channel

    for x in range(dim):
        # one-body
        for so in spins:
            for q in range(n):
                r1 = apply_annihilate(x, q + so)
                if r1 is None:
                    continue
                s1_state, s1 = r1
                for p in range(n):
                    if abs(h1[p, q]) < 1e-15:
                        continue
                    r2 = apply_create(s1_state, p + so)
                    if r2 is None:
                        continue
                    y, s2 = r2
                    H[y, x] += h1[p, q] * s1 * s2
        # two-body: 1/2 (pq|rs) a+_{p,s1} a+_{r,s2} a_{s,s2} a_{q,s1}
        for so1 in spins:
            for so2 in spins:
                for q in range(n):
                    rq = apply_annihilate(x, q + so1)
                    if rq is None:
                        continue
                    xq, sq = rq
                    for s in range(n):
                        rs = apply_annihilate(xq, s + so2)
                        if rs is None:
                            continue
                        xs, ss = rs
                        for r in range(n):
                            rr = apply_create(xs, r + so2)
                            if rr is None:
                                continue
                            xr, sr = rr
                            for p in range(n):
                                v = h2[p, q, r, s]
                                if abs(v) < 1e-15:
                                    continue
                                rp = apply_create(xr, p + so1)
                                if rp is None:
                                    continue
                                y, sp = rp
                                H[y, x] += 0.5 * v * sq * ss * sr * sp
    H += np.eye(dim) * e_nuc
    return H
