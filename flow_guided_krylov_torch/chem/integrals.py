"""McMurchie-Davidson Gaussian integral engine (host-side, float64 NumPy).

Replaces the reference's PySCF dependency
(its ``hamiltonians/molecular.py:945-1003``).  Computes
overlap, kinetic, nuclear-attraction and electron-repulsion integrals over
contracted Cartesian Gaussians via Hermite expansion (McMurchie & Davidson,
JCP 26, 218 (1978)).  Only s and p shells are required for the supported
basis sets (STO-3G / 6-31G, first row), but the recurrences are general.

Integrals are evaluated on the host in float64 — the same host/device split
the reference uses (PySCF on CPU, tensors shipped to the accelerator).
A C++ ERI engine (``native/integrals.cpp``) accelerates the O(n^4) ERI
loop when built; this module is the reference implementation and fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
from scipy.special import gammainc, gammaln

from .basis import Shell

__all__ = [
    "BasisFunction", "expand_shells", "overlap_matrix", "kinetic_matrix",
    "nuclear_attraction_matrix", "eri_tensor", "boys",
]

_DOUBLE_FACT = {-1: 1.0, 0: 1.0, 1: 1.0, 2: 2.0, 3: 3.0, 4: 8.0, 5: 15.0}


def _double_factorial(n: int) -> float:
    if n <= 1:
        return 1.0
    r = 1.0
    while n > 1:
        r *= n
        n -= 2
    return r


@dataclass
class BasisFunction:
    """One contracted Cartesian Gaussian x^l y^m z^n exp(-a r^2)."""
    lmn: Tuple[int, int, int]
    center: np.ndarray      # (3,) Bohr
    exps: np.ndarray        # (K,)
    coefs: np.ndarray       # (K,) includes primitive norms and contraction norm


def _primitive_norm(a: float, lmn: Tuple[int, int, int]) -> float:
    l, m, n = lmn
    L = l + m + n
    num = (2.0 * a / np.pi) ** 0.75 * (4.0 * a) ** (L / 2.0)
    den = np.sqrt(_double_factorial(2 * l - 1)
                  * _double_factorial(2 * m - 1)
                  * _double_factorial(2 * n - 1))
    return num / den


def expand_shells(shells: Sequence[Shell]) -> List[BasisFunction]:
    """Expand shells into contracted Cartesian basis functions (s; px,py,pz)."""
    funcs: List[BasisFunction] = []
    for sh in shells:
        if sh.l == 0:
            cart = [(0, 0, 0)]
        elif sh.l == 1:
            cart = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
        elif sh.l == 2:
            # 6 Cartesian d components (the Pople-basis convention)
            cart = [(2, 0, 0), (0, 2, 0), (0, 0, 2),
                    (1, 1, 0), (1, 0, 1), (0, 1, 1)]
        else:
            raise NotImplementedError(f"l={sh.l} shells not supported")
        for lmn in cart:
            norms = np.array([_primitive_norm(a, lmn) for a in sh.exps])
            coefs = sh.coefs * norms
            bf = BasisFunction(lmn=lmn, center=sh.center,
                               exps=sh.exps.copy(), coefs=coefs)
            # contracted self-overlap renormalization
            s = _contracted_overlap(bf, bf)
            bf.coefs = bf.coefs / np.sqrt(s)
            funcs.append(bf)
    return funcs


def _E(i: int, j: int, t: int, Q: float, a: float, b: float) -> float:
    """Hermite expansion coefficient E_t^{ij} (1-D), McMurchie-Davidson."""
    p = a + b
    q = a * b / p
    if t < 0 or t > i + j:
        return 0.0
    if i == j == t == 0:
        return np.exp(-q * Q * Q)
    if j == 0:
        # decrement i
        return (_E(i - 1, j, t - 1, Q, a, b) / (2 * p)
                - (q * Q / a) * _E(i - 1, j, t, Q, a, b)
                + (t + 1) * _E(i - 1, j, t + 1, Q, a, b))
    # decrement j
    return (_E(i, j - 1, t - 1, Q, a, b) / (2 * p)
            + (q * Q / b) * _E(i, j - 1, t, Q, a, b)
            + (t + 1) * _E(i, j - 1, t + 1, Q, a, b))


def _overlap_prim(a, lmn1, A, b, lmn2, B) -> float:
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    p = a + b
    sx = _E(l1, l2, 0, A[0] - B[0], a, b)
    sy = _E(m1, m2, 0, A[1] - B[1], a, b)
    sz = _E(n1, n2, 0, A[2] - B[2], a, b)
    return sx * sy * sz * (np.pi / p) ** 1.5


def _contracted_overlap(f1: BasisFunction, f2: BasisFunction) -> float:
    s = 0.0
    for a, ca in zip(f1.exps, f1.coefs):
        for b, cb in zip(f2.exps, f2.coefs):
            s += ca * cb * _overlap_prim(a, f1.lmn, f1.center, b, f2.lmn, f2.center)
    return s


def _kinetic_prim(a, lmn1, A, b, lmn2, B) -> float:
    """Kinetic energy via the standard overlap-combination formula."""
    l2, m2, n2 = lmn2
    term0 = b * (2 * (l2 + m2 + n2) + 3) * _overlap_prim(a, lmn1, A, b, lmn2, B)
    term1 = -2.0 * b ** 2 * (
        _overlap_prim(a, lmn1, A, b, (l2 + 2, m2, n2), B)
        + _overlap_prim(a, lmn1, A, b, (l2, m2 + 2, n2), B)
        + _overlap_prim(a, lmn1, A, b, (l2, m2, n2 + 2), B))
    term2 = -0.5 * (
        l2 * (l2 - 1) * _overlap_prim(a, lmn1, A, b, (l2 - 2, m2, n2), B)
        + m2 * (m2 - 1) * _overlap_prim(a, lmn1, A, b, (l2, m2 - 2, n2), B)
        + n2 * (n2 - 1) * _overlap_prim(a, lmn1, A, b, (l2, m2, n2 - 2), B))
    return term0 + term1 + term2


def boys(n_max: int, T: float) -> np.ndarray:
    """Boys functions F_0..F_n_max(T) via the regularized lower-incomplete gamma."""
    out = np.empty(n_max + 1)
    if T < 1e-13:
        for n in range(n_max + 1):
            out[n] = 1.0 / (2 * n + 1)
        return out
    ns = np.arange(n_max + 1)
    # F_n(T) = Gamma(n+1/2) * P(n+1/2, T) / (2 T^{n+1/2})
    out = (np.exp(gammaln(ns + 0.5)) * gammainc(ns + 0.5, T)
           / (2.0 * T ** (ns + 0.5)))
    return out


def _R_tensor(t_max: int, u_max: int, v_max: int, p: float,
              PC: np.ndarray) -> np.ndarray:
    """Hermite Coulomb integrals R^0_{tuv} as a dense (t,u,v) table."""
    L = t_max + u_max + v_max
    T = p * float(PC @ PC)
    F = boys(L, T)
    # R^n_{000} = (-2p)^n F_n(T)
    Rn = {(0, 0, 0, n): (-2.0 * p) ** n * F[n] for n in range(L + 1)}

    def get(t, u, v, n):
        if t < 0 or u < 0 or v < 0:
            return 0.0
        key = (t, u, v, n)
        if key in Rn:
            return Rn[key]
        if t >= 1:
            val = (t - 1) * get(t - 2, u, v, n + 1) + PC[0] * get(t - 1, u, v, n + 1)
        elif u >= 1:
            val = (u - 1) * get(t, u - 2, v, n + 1) + PC[1] * get(t, u - 1, v, n + 1)
        else:
            val = (v - 1) * get(t, u, v - 2, n + 1) + PC[2] * get(t, u, v - 1, n + 1)
        Rn[key] = val
        return val

    out = np.empty((t_max + 1, u_max + 1, v_max + 1))
    for t in range(t_max + 1):
        for u in range(u_max + 1):
            for v in range(v_max + 1):
                out[t, u, v] = get(t, u, v, 0)
    return out


def _nuclear_prim(a, lmn1, A, b, lmn2, B, C) -> float:
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    p = a + b
    P = (a * A + b * B) / p
    Ex = [_E(l1, l2, t, A[0] - B[0], a, b) for t in range(l1 + l2 + 1)]
    Ey = [_E(m1, m2, u, A[1] - B[1], a, b) for u in range(m1 + m2 + 1)]
    Ez = [_E(n1, n2, v, A[2] - B[2], a, b) for v in range(n1 + n2 + 1)]
    R = _R_tensor(l1 + l2, m1 + m2, n1 + n2, p, P - C)
    val = 0.0
    for t in range(l1 + l2 + 1):
        for u in range(m1 + m2 + 1):
            for v in range(n1 + n2 + 1):
                val += Ex[t] * Ey[u] * Ez[v] * R[t, u, v]
    return 2.0 * np.pi / p * val


def overlap_matrix(funcs: List[BasisFunction]) -> np.ndarray:
    n = len(funcs)
    S = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            S[i, j] = S[j, i] = _contracted_overlap(funcs[i], funcs[j])
    return S


def kinetic_matrix(funcs: List[BasisFunction]) -> np.ndarray:
    n = len(funcs)
    T = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            v = 0.0
            fi, fj = funcs[i], funcs[j]
            for a, ca in zip(fi.exps, fi.coefs):
                for b, cb in zip(fj.exps, fj.coefs):
                    v += ca * cb * _kinetic_prim(a, fi.lmn, fi.center,
                                                 b, fj.lmn, fj.center)
            T[i, j] = T[j, i] = v
    return T


def nuclear_attraction_matrix(funcs: List[BasisFunction],
                              charges: np.ndarray,
                              coords: np.ndarray) -> np.ndarray:
    n = len(funcs)
    V = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            v = 0.0
            fi, fj = funcs[i], funcs[j]
            for a, ca in zip(fi.exps, fi.coefs):
                for b, cb in zip(fj.exps, fj.coefs):
                    for Z, C in zip(charges, coords):
                        v -= Z * ca * cb * _nuclear_prim(
                            a, fi.lmn, fi.center, b, fj.lmn, fj.center, C)
            V[i, j] = V[j, i] = v
    return V


def _eri_prim(a, lmn1, A, b, lmn2, B, c, lmn3, C, d, lmn4, D) -> float:
    l1, m1, n1 = lmn1
    l2, m2, n2 = lmn2
    l3, m3, n3 = lmn3
    l4, m4, n4 = lmn4
    p = a + b
    q = c + d
    alpha = p * q / (p + q)
    P = (a * A + b * B) / p
    Q = (c * C + d * D) / q

    E1x = [_E(l1, l2, t, A[0] - B[0], a, b) for t in range(l1 + l2 + 1)]
    E1y = [_E(m1, m2, u, A[1] - B[1], a, b) for u in range(m1 + m2 + 1)]
    E1z = [_E(n1, n2, v, A[2] - B[2], a, b) for v in range(n1 + n2 + 1)]
    E2x = [_E(l3, l4, t, C[0] - D[0], c, d) for t in range(l3 + l4 + 1)]
    E2y = [_E(m3, m4, u, C[1] - D[1], c, d) for u in range(m3 + m4 + 1)]
    E2z = [_E(n3, n4, v, C[2] - D[2], c, d) for v in range(n3 + n4 + 1)]

    R = _R_tensor(l1 + l2 + l3 + l4, m1 + m2 + m3 + m4, n1 + n2 + n3 + n4,
                  alpha, P - Q)
    val = 0.0
    for t in range(l1 + l2 + 1):
        for u in range(m1 + m2 + 1):
            for v in range(n1 + n2 + 1):
                e1 = E1x[t] * E1y[u] * E1z[v]
                if e1 == 0.0:
                    continue
                for tt in range(l3 + l4 + 1):
                    for uu in range(m3 + m4 + 1):
                        for vv in range(n3 + n4 + 1):
                            e2 = E2x[tt] * E2y[uu] * E2z[vv]
                            if e2 == 0.0:
                                continue
                            sign = (-1.0) ** (tt + uu + vv)
                            val += e1 * e2 * sign * R[t + tt, u + uu, v + vv]
    return val * 2.0 * np.pi ** 2.5 / (p * q * np.sqrt(p + q))


def _eri_contracted(f1, f2, f3, f4) -> float:
    v = 0.0
    for a, ca in zip(f1.exps, f1.coefs):
        for b, cb in zip(f2.exps, f2.coefs):
            for c, cc in zip(f3.exps, f3.coefs):
                for d, cd in zip(f4.exps, f4.coefs):
                    v += ca * cb * cc * cd * _eri_prim(
                        a, f1.lmn, f1.center, b, f2.lmn, f2.center,
                        c, f3.lmn, f3.center, d, f4.lmn, f4.center)
    return v


def eri_tensor(funcs: List[BasisFunction]) -> np.ndarray:
    """(ij|kl) chemist-notation ERI tensor with 8-fold symmetry."""
    try:
        from .native import eri_tensor_native
        out = eri_tensor_native(funcs)
        if out is not None:
            return out
    except ImportError:
        pass
    n = len(funcs)
    eri = np.zeros((n, n, n, n))
    for i in range(n):
        for j in range(i + 1):
            for k in range(i + 1):
                lmax = j if k == i else k
                for l in range(lmax + 1):
                    v = _eri_contracted(funcs[i], funcs[j], funcs[k], funcs[l])
                    eri[i, j, k, l] = eri[j, i, k, l] = v
                    eri[i, j, l, k] = eri[j, i, l, k] = v
                    eri[k, l, i, j] = eri[l, k, i, j] = v
                    eri[k, l, j, i] = eri[l, k, j, i] = v
    return eri
