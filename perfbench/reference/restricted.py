"""Plain reference for restricted molecular SKQD: H over a given set of
determinants, its propagator, and the exact Epstein-Nesbet dE2 of a basis.

Plain PyTorch, float64, on any device; it shares no code with the program
and calls no kernel of its own.  A determinant is a pair of occupation
words (alpha, beta): bit p of a word is spatial orbital p of that spin.
Spin orbitals are ordered alpha block first, so the sign of a beta
excitation counts beta electrons only (the alpha ones stand before both
of its operators).  The integrals are the spatial ``h1e[p, q]`` and the
chemist-notation ``h2e[p, q, r, s] = (pq|rs)`` of the benchmark's
``.npz`` file, at most 31 orbitals (one int64 key ``alpha << 32 | beta``).

* :func:`connections`: every single and double excitation of each row
  with its Slater-Condon element:

  - diagonal: E_nuc + sum_i h_ii + 1/2 sum_ij <ij||ij>;
  - single i -> a of one spin: s (h_ai + sum_k [(ai|kk) - (ak|ki)]
    over that spin's electrons + sum_k (ai|kk) over the other's);
  - same-spin double i < j -> a < b: s ((ai|bj) - (aj|bi));
  - opposite-spin double i -> a (alpha), j -> b (beta): s_a s_b (ai|bj),

  s the sign of a+_a a+_b a_j a_i (a+_a a_i for a single) on the
  occupation word, from the count of electrons below each operator.
* :func:`hamiltonian`: (a) the rows of H over a set of determinants,
  built in row blocks; each connection's target is found by a search of
  the set's sorted keys, and one that leaves the set is dropped.  A
  float64 CSR matrix in the set's order, and its diagonal.
* :func:`propagate`: (b) exp(-i dt H) psi by a truncated Taylor series.
* :func:`pt2`: (c) the exact dE2 of a basis, every external determinant
  summed in float64, and each external's PT2 score.
* :func:`ground_state`: the lowest eigenpair of a CSR H in float64.
  (d), the projected H of a reported basis, is
  ``slater.projected_hamiltonian``.

Departures from the textbook formulas:

* The Taylor series runs on H - c, c the middle of H's Gershgorin
  interval, in substeps of dt / s with dt * r / s <= 1 (r the interval's
  half width), each summed until a term's norm falls to ``tol`` of the
  state's; the phase exp(-i c dt) is put back once at the end.  Without
  the shift |dt H| is about 11 and the series would cancel to 1e-11.
* Each Krylov state is renormalized after its evolve, as the program's
  sampler normalizes; exp(-i dt H) is unitary, so this changes the state
  by the truncation error alone.
* The benchmark's control runs one precision down: with ``dtype=
  torch.bfloat16`` every element, amplitude and coefficient is rounded
  to bfloat16 before each product, and sums run in float32 (a
  bfloat16 tensor core's arithmetic).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["Integrals", "connections", "diagonal", "hamiltonian",
           "propagate", "krylov_states", "pt2", "ground_state",
           "excitation_rank", "rank_probabilities", "restricted_problems",
           "keys_of"]

BLOCK_ENTRIES = 1 << 25      # connections worked at once (rows x C)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype``'s precision, kept in float32 when that is
    bfloat16 (the control), else in ``dtype``."""
    if dtype == torch.bfloat16:
        return x.to(torch.bfloat16).float()
    return x.to(dtype)


class Integrals:
    """The integrals on ``device`` in float64, and the index patterns of
    every excitation of an (n_alpha, n_beta) determinant."""

    def __init__(self, h1e, h2e, e_nuc: float, n_alpha: int, n_beta: int,
                 device="cpu"):
        self.device = torch.device(device)
        # the control's float32 products must be float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        f64 = dict(dtype=torch.float64, device=self.device)
        self.h1 = torch.as_tensor(np.asarray(h1e), **f64)
        self.h2 = torch.as_tensor(np.asarray(h2e), **f64)
        self.e_nuc = float(e_nuc)
        self.n = self.h1.shape[0]
        if self.n > 31:
            raise ValueError("one int64 key holds at most 31 orbitals")
        self.n_alpha, self.n_beta = int(n_alpha), int(n_beta)
        # D[a, i, m] = (ai|mm), X[a, i, m] = (am|mi)
        self.D = torch.einsum("aimm->aim", self.h2).contiguous()
        self.X = torch.einsum("ammi->aim", self.h2).contiguous()
        self.J = torch.einsum("iijj->ij", self.h2)
        self.K = torch.einsum("ijji->ij", self.h2)

    def pairs(self, k: int):
        """(x, y) index lists of one spin's singles: the x-th electron to
        the y-th hole."""
        nv = self.n - k
        x = torch.arange(k, device=self.device).repeat_interleave(nv)
        y = torch.arange(nv, device=self.device).repeat(k)
        return x, y

    def double_pairs(self, k: int):
        """(x1, x2, y1, y2) of one spin's doubles: electrons x1 < x2 to
        holes y1 < y2."""
        nv = self.n - k
        xs = torch.combinations(torch.arange(k, device=self.device), 2)
        ys = torch.combinations(torch.arange(nv, device=self.device), 2)
        if len(xs) == 0 or len(ys) == 0:
            e = torch.zeros(0, dtype=torch.long, device=self.device)
            return e, e, e, e
        xi = xs.repeat_interleave(len(ys), 0)
        yi = ys.repeat(len(xs), 1)
        return xi[:, 0], xi[:, 1], yi[:, 0], yi[:, 1]

    @property
    def n_connections(self) -> int:
        c = 0
        for k in (self.n_alpha, self.n_beta):
            nv = self.n - k
            c += k * nv + math.comb(k, 2) * math.comb(nv, 2)
        return c + (self.n_alpha * (self.n - self.n_alpha)
                    * self.n_beta * (self.n - self.n_beta))


def keys_of(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return (alpha << 32) | beta


def _occupation(w: torch.Tensor, n: int, k: int):
    """bits (M, n), occupied (M, k) and empty (M, n - k) orbitals in
    ascending order, and the count of electrons below each orbital."""
    ar = torch.arange(n, device=w.device)
    bits = (w[:, None] >> ar) & 1
    order = torch.argsort(1 - bits, dim=1, stable=True)
    below = torch.cumsum(bits, 1) - bits
    return bits, order[:, :k], order[:, k:], below


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, idx)


def _parity(x: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * (x & 1).double()


def diagonal(ints: Integrals, alpha: torch.Tensor,
             beta: torch.Tensor) -> torch.Tensor:
    """H_kk of each determinant, float64."""
    n = ints.n
    ar = torch.arange(n, device=alpha.device)
    ba = ((alpha[:, None] >> ar) & 1).double()
    bb = ((beta[:, None] >> ar) & 1).double()
    hd = torch.diagonal(ints.h1)
    JK = ints.J - ints.K
    e = ints.e_nuc + ba @ hd + bb @ hd
    e = e + 0.5 * ((ba @ JK) * ba).sum(1) + 0.5 * ((bb @ JK) * bb).sum(1)
    return e + ((ba @ ints.J) * bb).sum(1)


def _singles(ints, w, bits, occ, vir, below, other_bits, x, y):
    """One spin's singles: (new words, elements) (M, S)."""
    i, a = _take(occ, x.expand(len(w), -1)), _take(vir, y.expand(len(w), -1))
    par = _take(below, i) + _take(below, a) - (i < a).long()
    new = w[:, None] ^ (1 << i) ^ (1 << a)
    D = ints.D[a, i]                      # (M, S, n)
    Xm = ints.X[a, i]
    same = bits[:, None, :].double()
    other = other_bits[:, None, :].double()
    el = (ints.h1[a, i] + ((D - Xm) * same).sum(-1)
          + (D * other).sum(-1))
    return new, _parity(par) * el


def _doubles(ints, w, occ, vir, below, x1, x2, y1, y2):
    """One spin's doubles i < j -> a < b: (new words, elements)."""
    M = len(w)
    i, j = _take(occ, x1.expand(M, -1)), _take(occ, x2.expand(M, -1))
    a, b = _take(vir, y1.expand(M, -1)), _take(vir, y2.expand(M, -1))
    bi, bj = _take(below, i), _take(below, j)
    ba, bb = _take(below, a), _take(below, b)
    # a_i, then a_j on w - i, a+_b on w - i - j, a+_a on w - i - j + b
    par = (bi + (bj - 1) + (bb - (i < b).long() - (j < b).long())
           + (ba - (i < a).long() - (j < a).long()))
    new = w[:, None] ^ (1 << i) ^ (1 << j) ^ (1 << a) ^ (1 << b)
    el = ints.h2[a, i, b, j] - ints.h2[a, j, b, i]
    return new, _parity(par) * el


def connections(ints: Integrals, alpha: torch.Tensor, beta: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every single and double excitation of each (alpha, beta) row:
    (new alpha (M, C), new beta (M, C), float64 element (M, C)), C =
    ``ints.n_connections``, in an order of this module's own."""
    n, na, nb = ints.n, ints.n_alpha, ints.n_beta
    M = len(alpha)
    bits_a, occ_a, vir_a, bel_a = _occupation(alpha, n, na)
    bits_b, occ_b, vir_b, bel_b = _occupation(beta, n, nb)
    A, B, E = [], [], []
    rep_a = lambda t: alpha[:, None].expand_as(t)   # noqa: E731
    rep_b = lambda t: beta[:, None].expand_as(t)    # noqa: E731
    xa, ya = ints.pairs(na)
    xb, yb = ints.pairs(nb)
    new, el = _singles(ints, alpha, bits_a, occ_a, vir_a, bel_a, bits_b,
                       xa, ya)
    A.append(new), B.append(rep_b(new)), E.append(el)
    new, el = _singles(ints, beta, bits_b, occ_b, vir_b, bel_b, bits_a,
                       xb, yb)
    A.append(rep_a(new)), B.append(new), E.append(el)
    new, el = _doubles(ints, alpha, occ_a, vir_a, bel_a,
                       *ints.double_pairs(na))
    A.append(new), B.append(rep_b(new)), E.append(el)
    new, el = _doubles(ints, beta, occ_b, vir_b, bel_b,
                       *ints.double_pairs(nb))
    A.append(rep_a(new)), B.append(new), E.append(el)
    # opposite spins: every alpha single with every beta single
    i, a = _take(occ_a, xa.expand(M, -1)), _take(vir_a, ya.expand(M, -1))
    j, b = _take(occ_b, xb.expand(M, -1)), _take(vir_b, yb.expand(M, -1))
    sa = _parity(_take(bel_a, i) + _take(bel_a, a) - (i < a).long())
    sb = _parity(_take(bel_b, j) + _take(bel_b, b) - (j < b).long())
    Sa, Sb = i.shape[1], j.shape[1]
    el = (ints.h2[a[:, :, None], i[:, :, None], b[:, None, :], j[:, None, :]]
          * sa[:, :, None] * sb[:, None, :]).reshape(M, Sa * Sb)
    na_w = (alpha[:, None] ^ (1 << i) ^ (1 << a))[:, :, None].expand(
        M, Sa, Sb).reshape(M, -1)
    nb_w = (beta[:, None] ^ (1 << j) ^ (1 << b))[:, None, :].expand(
        M, Sa, Sb).reshape(M, -1)
    A.append(na_w), B.append(nb_w), E.append(el)
    return torch.cat(A, 1), torch.cat(B, 1), torch.cat(E, 1)


def _rows_per_block(ints: Integrals) -> int:
    return max(1, BLOCK_ENTRIES // max(ints.n_connections, 1))


def hamiltonian(ints: Integrals, dets: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a): H over ``dets`` ((N, 2) words, each once) as a float64 CSR
    matrix on ``ints.device`` in the rows' order, columns ascending in
    each row, and its diagonal (N,).  Rows are worked a block at a time;
    a connection whose target is not in the set, or whose element is
    exactly 0, is dropped."""
    dev = ints.device
    d = torch.as_tensor(np.asarray(dets, np.int64), device=dev)
    N = len(d)
    key = keys_of(d[:, 0], d[:, 1])
    skey, order = torch.sort(key)
    rows_blk = _rows_per_block(ints)
    counts, cols, vals = [], [], []
    diag = torch.empty(N, dtype=torch.float64, device=dev)
    for r0 in range(0, N, rows_blk):
        r1 = min(N, r0 + rows_blk)
        a, b = d[r0:r1, 0], d[r0:r1, 1]
        na_w, nb_w, el = connections(ints, a, b)
        k = keys_of(na_w, nb_w)
        pos = torch.searchsorted(skey, k).clamp_(max=N - 1)
        hit = (skey[pos] == k) & (el != 0)
        col = torch.where(hit, order[pos], N)
        del k, pos, na_w, nb_w
        # the diagonal joins its row as one more column
        dg = diagonal(ints, a, b)
        diag[r0:r1] = dg
        own = torch.arange(r0, r1, device=dev)[:, None]
        col = torch.cat([col, own], 1)
        el = torch.cat([torch.where(hit, el, 0.0), dg[:, None]], 1)
        col, perm = torch.sort(col, 1)
        el = torch.gather(el, 1, perm)
        keep = col < N
        counts.append(keep.sum(1))
        cols.append(col[keep])
        vals.append(el[keep])
        del col, el, perm, keep, hit
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.cat(counts), 0)
    return _csr(crow, torch.cat(cols), torch.cat(vals), N), diag


def _csr(crow, col, val, n: int) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # "sparse CSR is in beta"
        return torch.sparse_csr_tensor(crow, col, val, (n, n),
                                       check_invariants=False)


def _matmul(H: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    return _round(torch.sparse.mm(H, v), dtype)


def propagate(H: torch.Tensor, diag: torch.Tensor, re: torch.Tensor,
              im: torch.Tensor, dt: float, tol: float = 1e-12,
              dtype=torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b): exp(-i dt H) (re + i im) by a Taylor series of -i dt (H - c)
    in substeps (module docstring); float64, or the control's bfloat16
    with ``dtype=torch.bfloat16``."""
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    n = H.shape[0]
    absrow = _csr(H.crow_indices(), H.col_indices(), H.values().abs(), n)
    radius = (torch.sparse.mm(absrow, torch.ones(
        H.shape[0], 1, dtype=torch.float64, device=H.device))[:, 0]
        - diag.abs())
    lo = float((diag - radius).min())
    hi = float((diag + radius).max())
    c, r = 0.5 * (lo + hi), 0.5 * (hi - lo)
    steps = max(1, math.ceil(dt * r))
    tau = dt / steps
    Hw = H if work == torch.float64 else _csr(
        H.crow_indices(), H.col_indices(), _round(H.values(), dtype), n)
    v = _round(torch.stack([re, im], 1), dtype)
    for _ in range(steps):
        acc, term = v, v
        for k in range(1, 400):
            # -i tau (H - c) (x + i y) = tau (H - c) y - i tau (H - c) x
            rot = torch.stack([term[:, 1], -term[:, 0]], 1)
            term = _round((tau / k) * (_matmul(Hw, rot, dtype)
                                       - c * rot), dtype)
            acc = _round(acc + term, dtype)
            if float(torch.linalg.norm(term)) <= tol * float(
                    torch.linalg.norm(acc)):
                break
        else:
            raise RuntimeError("the Taylor series did not converge")
        v = acc
    ph = -c * dt
    cs, sn = math.cos(ph), math.sin(ph)
    out_re = cs * v[:, 0] - sn * v[:, 1]
    out_im = sn * v[:, 0] + cs * v[:, 1]
    return _round(out_re, dtype), _round(out_im, dtype)


def krylov_states(H: torch.Tensor, diag: torch.Tensor, start: int, n: int,
                  dt: float, dtype=torch.float64
                  ) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """(k, re, im) of exp(-i dt H)^k |start>, renormalized, k = 1..n."""
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    re = torch.zeros(H.shape[0], dtype=work, device=H.device)
    re[start] = 1.0
    im = torch.zeros_like(re)
    for k in range(1, n + 1):
        re, im = propagate(H, diag, re, im, dt, dtype=dtype)
        norm = torch.sqrt(torch.sum(re.double() ** 2 + im.double() ** 2))
        re, im = (re.double() / norm).to(work), (im.double() / norm).to(work)
        yield k, re, im


def ground_state(H: torch.Tensor) -> Tuple[float, np.ndarray]:
    """Lowest eigenvalue and its vector of a symmetric CSR H in float64:
    a dense ``eigh`` to 4,000 rows, SciPy's ``eigsh`` (tol 0) past it."""
    N = H.shape[0]
    if N <= 4000:
        w, V = torch.linalg.eigh(H.to_dense().double())
        return float(w[0]), V[:, 0].cpu().numpy()
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    Hs = sp.csr_matrix((H.values().cpu().numpy(),
                        H.col_indices().cpu().numpy(),
                        H.crow_indices().cpu().numpy()), shape=(N, N))
    v0 = np.ones(N) / np.sqrt(N)
    w, V = spla.eigsh(Hs, k=1, which="SA", v0=v0, tol=0.0)
    return float(w[0]), V[:, 0]


def pt2(ints: Integrals, basis: np.ndarray, coeffs: np.ndarray,
        energy: float, dtype=torch.float64) -> Dict:
    """(c): the exact Epstein-Nesbet dE2 = sum_k <k|H|Phi>^2 / (E - H_kk)
    over every determinant k outside ``basis`` connected to it, with
    Phi = sum_j c_j |j>.  Returns ``de2``, the externals' words
    ``externals`` (X, 2) and their ``scores`` <k|H|Phi>^2 / |E - H_kk|.
    With ``dtype=torch.bfloat16`` (the control) elements and coefficients
    are rounded to bfloat16 and the couplings summed in float32."""
    dev = ints.device
    d = torch.as_tensor(np.asarray(basis, np.int64), device=dev)
    c = torch.as_tensor(np.asarray(coeffs, np.float64), device=dev)
    work = torch.float32 if dtype == torch.bfloat16 else torch.float64
    bkey = torch.sort(keys_of(d[:, 0], d[:, 1]))[0]
    keys, contrib = [], []
    rows_blk = _rows_per_block(ints)
    for r0 in range(0, len(d), rows_blk):
        na_w, nb_w, el = connections(ints, d[r0:r0 + rows_blk, 0],
                                     d[r0:r0 + rows_blk, 1])
        k = keys_of(na_w, nb_w).reshape(-1)
        v = (_round(el, dtype) * _round(c[r0:r0 + rows_blk, None], dtype)
             ).to(work).reshape(-1)
        pos = torch.searchsorted(bkey, k).clamp_(max=len(bkey) - 1)
        out = bkey[pos] != k
        keys.append(k[out])
        contrib.append(v[out])
    keys, contrib = torch.cat(keys), torch.cat(contrib)
    uniq, inv = torch.unique(keys, return_inverse=True)
    coupling = torch.zeros(len(uniq), dtype=work, device=dev)
    coupling.index_add_(0, inv, contrib)
    alpha, beta = uniq >> 32, uniq & 0xFFFFFFFF
    hkk = diagonal(ints, alpha, beta)
    coupling = coupling.double()
    de2 = float(torch.sum(coupling ** 2 / (energy - hkk)))
    scores = coupling ** 2 / (energy - hkk).abs()
    return {"de2": de2,
            "externals": torch.stack([alpha, beta], 1).cpu().numpy(),
            "scores": scores.cpu().numpy(),
            "n_external": int((coupling != 0).sum())}


def excitation_rank(dets: np.ndarray, hf: np.ndarray) -> np.ndarray:
    """Excitation rank of each determinant from ``hf``: half the
    occupation bits in which it differs."""
    dets = np.asarray(dets, np.int64)
    diff = dets ^ np.asarray(hf, np.int64)[None, :]
    pc = np.zeros(len(dets), np.int64)
    for col in range(diff.shape[1]):
        x = diff[:, col].copy()
        while np.any(x):
            pc += x & 1
            x >>= 1
    return pc // 2


def rank_probabilities(re: torch.Tensor, im: torch.Tensor,
                       ranks: torch.Tensor, n_ranks: int) -> np.ndarray:
    """|psi|^2 summed by excitation rank, float64."""
    p = re.double() ** 2 + im.double() ** 2
    out = torch.zeros(n_ranks, dtype=torch.float64, device=p.device)
    out.index_add_(0, ranks, p)
    return (out / out.sum()).cpu().numpy()


def restricted_problems(restricted: np.ndarray, basis: np.ndarray,
                        init: np.ndarray, cap: int,
                        externals: np.ndarray, scores: np.ndarray,
                        rel: float = 1e-9, floor: float = 1e-20) -> int:
    """Rows by which ``restricted`` is not ``basis`` (and ``init``) plus
    its top-scored externals up to ``cap`` rows: a basis row missing, a
    row past the cap, an added row that is no external, one scored
    below the cut (the score at the added count's rank, less ``rel``: a
    tie at the cut may fall either way), or, with room left, an external
    scored above ``floor`` left out."""
    def k(x):
        x = np.asarray(x, np.int64).reshape(-1, 2)
        return (x[:, 0] << 32) | x[:, 1]
    have = k(restricted)
    own = np.unique(np.concatenate([k(basis), k(init)]))
    bad = int(np.sum(~np.isin(own, have)))
    bad += max(0, len(have) - int(cap))
    added = np.setdiff1d(have, own)
    ext = k(externals)
    order = np.argsort(ext)
    ext, sc = ext[order], np.asarray(scores)[order]
    pos = np.clip(np.searchsorted(ext, added), 0, max(len(ext) - 1, 0))
    found = (ext[pos] == added) if len(ext) else np.zeros(len(added), bool)
    bad += int(np.sum(~found))
    if len(added):
        ranked = np.sort(sc)[::-1]
        cut = ranked[min(len(added), len(ranked)) - 1]
        bad += int(np.sum(sc[pos[found]] < cut * (1 - rel)))
        # the program's room: the cap less the basis and the initial
        # rows, counted apart even where the basis holds them
        room = int(cap) - len(basis) - len(init) - len(added)
        if room > 0:
            out = ~np.isin(ext, added) & ~np.isin(ext, own)
            bad += int(np.sum(out & (sc > floor)))
    return bad
