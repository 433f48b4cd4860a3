"""Plain Slater-Condon reference for a molecule in a determinant basis.

NumPy and SciPy alone, float64 throughout.  A determinant is a pair of
occupation words (alpha, beta): bit p of a word is spatial orbital p of
that spin.  Spin orbitals are ordered alpha block first, orbital order
within a block; each fermionic sign below follows from that order.

The integrals are the spatial one-body ``h1e[p, q]`` and the
chemist-notation two-body ``h2e[p, q, r, s] = (pq|rs)``, as the
benchmark's integrals file holds them.

Matrix elements (Slater-Condon, spin orbitals):

* diagonal: E_nuc + sum_i h_ii + 1/2 sum_ij <ij||ij>;
* single i -> a: s * (h_ai + sum_k <ak||ik>);
* double i, j -> a, b: s * <ab||ij>, with s the sign of
  a+_a a+_b a_j a_i acting on the determinant.
"""

from __future__ import annotations

from itertools import combinations
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from .eig import ground_energy

__all__ = ["load_integrals", "all_determinants", "projected_hamiltonian",
           "ground_energy", "fci_energy", "basis_problems"]


def load_integrals(path: str) -> Tuple[np.ndarray, np.ndarray, float]:
    """(h1e, h2e, nuclear repulsion) from the benchmark's ``.npz`` file."""
    with np.load(path) as z:
        return (np.asarray(z["h1e"], np.float64),
                np.asarray(z["h2e"], np.float64),
                float(z["nuclear_repulsion"]))


def _words(n: int, k: int) -> np.ndarray:
    return np.array(sorted(sum(1 << p for p in c)
                           for c in combinations(range(n), k)), np.int64)


def all_determinants(n: int, n_alpha: int, n_beta: int) -> np.ndarray:
    """Every determinant of n orbitals, (N, 2) int64 (alpha, beta)."""
    a, b = _words(n, n_alpha), _words(n, n_beta)
    return np.stack([np.repeat(a, len(b)), np.tile(b, len(a))], 1)


def _occ(words: np.ndarray, n: int, k: int) -> np.ndarray:
    """(N, k) occupied orbitals of each word, ascending."""
    bits = (words[:, None] >> np.arange(n)) & 1
    return np.nonzero(bits)[1].reshape(len(words), k)


def _vir(words: np.ndarray, n: int, k: int) -> np.ndarray:
    bits = (words[:, None] >> np.arange(n)) & 1
    return np.nonzero(bits == 0)[1].reshape(len(words), n - k)


def _below(words: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Number of set bits of each word strictly below bit p."""
    mask = (np.int64(1) << p) - 1
    x = words & mask
    count = np.zeros_like(x)
    while np.any(x):
        count += x & 1
        x = x >> 1
    return count


def _move(words: np.ndarray, i: np.ndarray, a: np.ndarray):
    """a+_a a_i on each word: (new words, sign)."""
    w1 = words & ~(np.int64(1) << i)
    n_flips = _below(words, i) + _below(w1, a)
    return w1 | (np.int64(1) << a), 1.0 - 2.0 * (n_flips & 1)


def _diagonal(occ_a, occ_b, h1, J, K, e_nuc):
    occ = [occ_a, occ_b]
    e = np.full(len(occ_a), e_nuc)
    for o in occ:
        e += h1[o, o].sum(1)
        Jo = J[o[:, :, None], o[:, None, :]]
        Ko = K[o[:, :, None], o[:, None, :]]
        e += 0.5 * (Jo - Ko).sum((1, 2))
    e += J[occ_a[:, :, None], occ_b[:, None, :]].sum((1, 2))
    return e


def projected_hamiltonian(dets: np.ndarray, n: int, n_alpha: int,
                          n_beta: int, h1: np.ndarray, h2: np.ndarray,
                          e_nuc: float) -> sp.csr_matrix:
    """H projected on ``dets`` ((N, 2) integer words, each row once):
    a symmetric float64 CSR matrix in the rows' order."""
    dets = np.asarray(dets, np.int64)
    N = len(dets)
    key = (dets[:, 0] << 32) | dets[:, 1]
    order = np.argsort(key)
    skey = key[order]
    J = np.einsum("iijj->ij", h2)
    K = np.einsum("ijji->ij", h2)
    wa, wb = dets[:, 0], dets[:, 1]
    oa, ob = _occ(wa, n, n_alpha), _occ(wb, n, n_beta)
    va, vb = _vir(wa, n, n_alpha), _vir(wb, n, n_beta)
    rows, cols, vals = [np.arange(N)], [np.arange(N)], [
        _diagonal(oa, ob, h1, J, K, e_nuc)]

    def add(src, new_a, new_b, elem):
        k = (new_a << 32) | new_b
        pos = np.clip(np.searchsorted(skey, k), 0, N - 1)
        hit = skey[pos] == k
        rows.append(order[pos[hit]])
        cols.append(src[hit])
        vals.append(elem[hit])

    idx = np.arange(N)
    for spin in (0, 1):
        occ_s, vir_s = (oa, va) if spin == 0 else (ob, vb)
        occ_o = ob if spin == 0 else oa
        w = dets[:, spin]
        ns = occ_s.shape[1]
        # singles i -> a of this spin
        for x in range(ns):
            for y in range(vir_s.shape[1]):
                i, a = occ_s[:, x], vir_s[:, y]
                new, sign = _move(w, i, a)
                same = occ_s                              # k of this spin
                f = (h1[a, i]
                     + (h2[a[:, None], i[:, None], same, same]
                        - h2[a[:, None], same, same, i[:, None]]).sum(1)
                     + h2[a[:, None], i[:, None], occ_o, occ_o].sum(1))
                # k = i adds (ai|ii) - (ai|ii) = 0 to the sum
                new_a, new_b = (new, wb) if spin == 0 else (wa, new)
                add(idx, new_a, new_b, sign * f)
        # same-spin doubles i < j -> a < b
        for x1, x2 in combinations(range(ns), 2):
            for y1, y2 in combinations(range(vir_s.shape[1]), 2):
                i, j = occ_s[:, x1], occ_s[:, x2]
                a, b = vir_s[:, y1], vir_s[:, y2]
                # a+_a a+_b a_j a_i: a_i, a_j, then a+_b, a+_a
                w1 = w & ~(np.int64(1) << i)
                s = _below(w, i)
                w2 = w1 & ~(np.int64(1) << j)
                s += _below(w1, j)
                w3 = w2 | (np.int64(1) << b)
                s += _below(w2, b)
                new = w3 | (np.int64(1) << a)
                s += _below(w3, a)
                sign = 1.0 - 2.0 * (s & 1)
                f = h2[a, i, b, j] - h2[a, j, b, i]
                new_a, new_b = (new, wb) if spin == 0 else (wa, new)
                add(idx, new_a, new_b, sign * f)
    # opposite-spin doubles i (alpha) -> a, j (beta) -> b
    for x1 in range(oa.shape[1]):
        for y1 in range(va.shape[1]):
            i, a = oa[:, x1], va[:, y1]
            new_a, sa = _move(wa, i, a)
            for x2 in range(ob.shape[1]):
                for y2 in range(vb.shape[1]):
                    j, b = ob[:, x2], vb[:, y2]
                    new_b, sb = _move(wb, j, b)
                    add(idx, new_a, new_b, sa * sb * h2[a, i, b, j])
    r, c, v = (np.concatenate(x) for x in (rows, cols, vals))
    return sp.csr_matrix((v, (r, c)), shape=(N, N))


def fci_energy(n: int, n_alpha: int, n_beta: int, h1, h2, e_nuc) -> float:
    dets = all_determinants(n, n_alpha, n_beta)
    return ground_energy(projected_hamiltonian(dets, n, n_alpha, n_beta,
                                               h1, h2, e_nuc))


def basis_problems(dets: np.ndarray, n: int, n_alpha: int,
                   n_beta: int) -> int:
    """Rows with a wrong electron count, a bit past n, or a repeat."""
    dets = np.asarray(dets, np.int64)
    bad = 0
    for col, k in ((0, n_alpha), (1, n_beta)):
        w = dets[:, col]
        bad += int(np.sum((w >> n) != 0))
        bad += int(np.sum(_below(w, np.full_like(w, n)) != k))
    key = (dets[:, 0] << 32) | dets[:, 1]
    bad += len(key) - len(np.unique(key))
    return bad
