"""Selected-CI basis expansion with PT2 importance (stage 3).

Counterpart of ``flow_guided_krylov_tpu/krylov/residual_expansion.py``
for every packing of ``hamiltonians/``:

* :class:`SelectedCIExpander` — one round: diagonalize the current basis
  (host float64), accumulate signed couplings <i|H|Phi> = sum_j c_j <i|H|j>
  over all external connected determinants, score
  eps_i = |<i|H|Phi>|^2 / |E - E_i|, add the top-k, rediagonalize, and
  reject the round if the energy rose.
* :class:`ResidualBasedExpander` — the raw-residual alternative:
  r_i = max_j |c_j <i|H|j>|, keep-max dedup, no PT2 denominator.
* :func:`iterative_residual_expansion` — the loop with stagnation-based
  early stopping, the ``growth_factor`` schedule and ``use_pt2=False``
  (the raw-residual expander).

* :meth:`SelectedCIExpander.pt2_correction` — the exact Epstein-Nesbet
  dE2 of a variational state over every external determinant, which the
  large-system records report beside E_var.

The host scoring path is the JAX package's NumPy code, so host-scored
trajectories are identical in both packages.  The device scoring block
(:meth:`SelectedCIExpander._pt2_topk_device`) and the device blocks of the
exact correction run in torch on the Hamiltonian's device.  Keys are one
int64 a configuration up to two words (spins up to 64 sites included);
4-word determinants (33..64 orbitals) key on an (alpha, beta) int64 pair,
ordered by two stable sorts (``hamiltonians/base.py::lex_order``), and
on the host on ``KEY128`` records.

With a ``mesh`` (``parallel.make_mesh``) the device blocks of the scoring
and of the exact correction split their source rows over the mesh's
entries: each shard connects, sorts, segment-sums and takes its own top-K
on its entry's device, and the host's grouped sum merges the shards'
partial couplings exactly, as it merges blocks.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..hamiltonians.base import (DENSE_SOLVE_MAX_ROWS, Hamiltonian,
                                 lex_order, lowest_pairs)
from ..ops.bits import to_device
from ..utils.profiling import count, span

__all__ = ["ResidualExpansionConfig", "SelectedCIExpander",
           "ResidualBasedExpander", "iterative_residual_expansion"]


def _sorted_unique(keys: np.ndarray, return_inverse: bool = False):
    """(unique_keys, first_index, inverse|None) of uint64 keys via one
    stable argsort and a grouped cumsum (cheaper than ``np.unique``'s
    int64-heavy internals).  ``KEY128`` records sort by ``np.lexsort``
    over their two uint64 halves: NumPy's record comparator costs a call
    a comparison."""
    if keys.dtype.kind == "V" and keys.dtype.itemsize == 16:
        v = keys.view(np.uint64).reshape(-1, 2)       # (alpha, beta)
        order = np.lexsort((v[:, 1], v[:, 0]))
        sv = v[order]
        flag = np.empty(len(keys), bool)
        if len(keys):
            flag[0] = True
            np.not_equal(sv[1:, 0], sv[:-1, 0], out=flag[1:])
            flag[1:] |= sv[1:, 1] != sv[:-1, 1]
        sk = keys[order]
    else:
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        flag = np.empty(len(sk), bool)
        if len(sk):
            flag[0] = True
            np.not_equal(sk[1:], sk[:-1], out=flag[1:])
    uniq = sk[flag]
    first_idx = order[flag]
    inverse = None
    if return_inverse:
        inverse = np.empty(len(keys), np.int32)
        inverse[order] = np.cumsum(flag, dtype=np.int32) - np.int32(1)
    return uniq, first_idx, inverse


def _sum_by_key(key: torch.Tensor, contrib: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique keys ascending, the signed sum of ``contrib`` over each) of
    (R,) int64 keys or (R, 2) key pairs (lexicographic order).  The sorts
    are stable and ``torch.segment_reduce`` adds each run's terms in their
    sorted order in one thread, so two calls give the same bits on a card
    (``index_add_`` adds with float atomics in no fixed order)."""
    order = lex_order(key)
    key, contrib = key[order], contrib[order]
    first = torch.ones(len(key), dtype=torch.bool, device=key.device)
    differ = key[1:] != key[:-1]
    first[1:] = differ if key.dim() == 1 else differ.any(-1)
    starts = torch.nonzero(first)[:, 0]
    lengths = torch.diff(starts, append=starts.new_tensor([len(key)]))
    return key[starts], torch.segment_reduce(contrib, "sum", lengths=lengths)


@dataclass
class ResidualExpansionConfig:
    """Expansion knobs (the JAX package's names and defaults)."""
    configs_per_iteration: int = 100
    residual_threshold: float = 1e-4
    max_iterations: int = 10
    energy_convergence: float = 1e-6
    stagnation_threshold: float = 5e-5    # 0.05 mHa
    stagnation_patience: int = 2
    max_basis_size: int = 4096
    coefficient_threshold: float = 1e-6   # |c_j| cutoff for source states
    # proportional growth: when > 0, each round of
    # iterative_residual_expansion adds max(configs_per_iteration,
    # growth_factor * len(basis)) states (0: the fixed schedule)
    growth_factor: float = 0.0
    # source screening: when > 0, a source row j is scored only if
    # |c_j| * Hmax >= source_screen * residual_threshold, Hmax the largest
    # off-diagonal |H_ij| of a strided sample of the sources.  A heuristic
    # (small sources can still add up across rows); the exact dE2 sums
    # over the whole basis regardless.  0 disables it.
    source_screen: float = 0.0
    # row cap of the device scorer: when > 0, each scoring block keeps
    # only its pt2_sort_rows rows of largest |c_j H_ij| (an exact top-k)
    # before the key sort, and at most that many candidates.  Selection
    # then drops rows that could only matter by accumulation, as the
    # source screen does; the exact dE2 never drops rows.  0 disables it.
    pt2_sort_rows: int = 0
    # warm-started Davidson for the per-round eigensolve above 2048 dets
    # (eigsh when it does not converge); False solves with warm eigsh only
    use_davidson: bool = True


class SelectedCIExpander:
    """PT2-scored Selected-CI expansion over packed determinants.

    * repeated diagonalizations of an unchanged basis hit a fingerprint
      cache (the end-of-round solve is the next round's start-of-round);
    * the projected sparse H grows incrementally: only the newly added
      rows' connections are enumerated per round;
    * PT2 candidate scoring runs on the host in f64, or on the device
      (sort, segment-sum, top-K) once a round's source batch passes
      ``DEVICE_SCORING_MIN_ELEMS`` connection evaluations.
    """

    # the JAX package's crossover, sized for TPU compile and transfer
    # costs; not yet measured on a GPU
    DEVICE_SCORING_MIN_ELEMS = 2_000_000

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[ResidualExpansionConfig] = None,
                 use_device_scoring: Optional[bool] = None,
                 mesh=None):
        self.h = hamiltonian
        self.mesh = mesh
        self.config = config or ResidualExpansionConfig()
        self._last_coeffs: Optional[np.ndarray] = None
        self.use_device_scoring = use_device_scoring
        # fingerprint -> (energy, coeffs) for the last few bases seen
        self._diag_cache: Dict[bytes, Tuple[float, np.ndarray]] = {}
        # incremental projected-H cache: consolidated prefix CSR + pending
        # per-round staircase blocks [(row_offset, B, B.T, D), ...]
        self._inc_keys: Optional[np.ndarray] = None
        self._inc_H = None
        self._pend: list = []
        self._pt2_row_cap: Optional[int] = None
        # the float64 connection functions of the multiword exact dE2, by
        # device
        self._conn_f64: Dict[torch.device, object] = {}
        # largest off-diagonal |H_ij| of a sample of sources, found once
        # for the source screen
        self._hmax: Optional[float] = None
        # cumulative wall per phase (diag = host eigensolve incl. the
        # incremental CSR growth; score = PT2 candidate scoring)
        self.timings: Dict[str, float] = {"diag": 0.0, "score": 0.0,
                                          "diag_build": 0.0}

    # ------------------------------------------------------------------

    def _projected_sparse(self, basis: np.ndarray, keys: np.ndarray):
        """Symmetric H over ``basis`` as a matvec operator, grown blockwise
        when the previous basis is a prefix (the iterative-expansion
        invariant).  Each round builds only its own (B, D) staircase
        blocks; the blocks fold into the prefix CSR every 16 rounds."""
        import scipy.sparse as sp

        n = len(basis)
        if self._inc_H is not None:
            m = len(self._inc_keys)
            if n >= m and np.array_equal(keys[:m], self._inc_keys):
                if n > m:
                    new = basis[m:]
                    n_new = n - m
                    order = np.argsort(keys)
                    sorted_keys = keys[order]
                    from ..ops.native_conn import conn_hits_native
                    nat = conn_hits_native(self.h, new, sorted_keys)
                    if nat is not None:
                        rows, spos, vals = nat
                        cols = order[spos]
                    else:
                        conn, elems = self.h.connections_np(new)
                        ck = self.h.keys(conn.reshape(-1, conn.shape[-1]))
                        pos = np.clip(np.searchsorted(sorted_keys, ck),
                                      0, n - 1)
                        hit = sorted_keys[pos] == ck
                        rows = np.repeat(np.arange(n_new),
                                         conn.shape[1])[hit]
                        cols = order[pos[hit]]
                        vals = elems.reshape(-1)[hit]
                    old = cols < m
                    B = sp.coo_matrix((vals[old], (rows[old], cols[old])),
                                      shape=(n_new, m)).tocsr()
                    D = sp.coo_matrix(
                        (vals[~old], (rows[~old], cols[~old] - m)),
                        shape=(n_new, n_new))
                    D = (0.5 * (D + D.T)
                         + sp.diags(self.h.diagonal_np(new))).tocsr()
                    self._pend.append((m, B, B.T.tocsr(), D))
                    self._inc_keys = keys.copy()
                    if len(self._pend) >= 16:
                        self._consolidate()
                return self._operator()
            if n < m and np.array_equal(keys, self._inc_keys[:n]):
                # variational rejection reverted the basis: restrict
                self._consolidate()
                self._inc_H = self._inc_H[:n, :n].tocsr()
                self._inc_keys = keys.copy()
                return self._inc_H

        M = self.h.to_sparse(basis)
        self._inc_H = ((M + M.T) * 0.5).tocsr()
        self._pend = []
        self._inc_keys = keys.copy()
        return self._inc_H

    def _consolidate(self) -> None:
        """Fold the pending staircase blocks into the prefix CSR."""
        if not self._pend:
            return
        import scipy.sparse as sp
        h0 = self._inc_H.tocoo()
        rs, cs, vs = [h0.row], [h0.col], [h0.data]
        n = self._inc_H.shape[0]
        for a, B, _, D in self._pend:
            nb = D.shape[0]
            b = B.tocoo()
            rs += [a + b.row, b.col]
            cs += [b.col, a + b.row]
            vs += [b.data, b.data]
            d = D.tocoo()
            rs.append(a + d.row)
            cs.append(a + d.col)
            vs.append(d.data)
            n = max(n, a + nb)
        self._inc_H = sp.coo_matrix(
            (np.concatenate(vs),
             (np.concatenate(rs), np.concatenate(cs))),
            shape=(n, n)).tocsr()
        self._pend = []

    def _operator(self):
        """The current projected H: the prefix CSR when nothing is
        pending, else a LinearOperator streaming prefix + blocks."""
        if not self._pend:
            return self._inc_H
        import scipy.sparse.linalg as spla
        H0 = self._inc_H
        m0 = H0.shape[0]
        pend = list(self._pend)
        n = pend[-1][0] + pend[-1][3].shape[0]

        def mv(x):
            x = np.asarray(x, np.float64).reshape(-1)
            y = np.zeros(n, np.float64)
            y[:m0] = H0 @ x[:m0]
            for a, B, BT, D in pend:
                nb = D.shape[0]
                y[a:a + nb] += B @ x[:a] + D @ x[a:a + nb]
                y[:a] += BT @ x[a:a + nb]
            return y

        return spla.LinearOperator((n, n), matvec=mv, dtype=np.float64)

    def _diagonalize(self, basis: np.ndarray) -> Tuple[float, np.ndarray]:
        """Ground state of H projected on basis (host f64), warm-started
        with the previous round's eigenvector."""
        t0 = time.perf_counter()
        try:
            return self._diagonalize_timed(basis)
        finally:
            self.timings["diag"] += time.perf_counter() - t0

    def _diagonalize_timed(self, basis: np.ndarray
                           ) -> Tuple[float, np.ndarray]:
        keys = self.h.keys(basis)
        fp = keys.tobytes()
        hit = self._diag_cache.get(fp)
        if hit is not None:
            self._last_coeffs = hit[1]
            return hit

        v0 = None
        prev = self._last_coeffs
        if prev is not None and len(prev) <= len(basis):
            v0 = np.zeros(len(basis))
            v0[:len(prev)] = prev

        if len(basis) > DENSE_SOLVE_MAX_ROWS:
            tb = time.perf_counter()
            M = self._projected_sparse(basis, keys)
            self.timings["diag_build"] += time.perf_counter() - tb
            if v0 is not None:
                # warm-started Davidson, eigsh when it does not converge
                # (or when use_davidson is off); eigenvalue error ~
                # rnorm^2 / gap, so tol 1e-7 is far below the 1e-6 Ha
                # convergence test
                e, vec = None, None
                if self.config.use_davidson:
                    from ..postprocessing.eigensolver import DavidsonSolver
                    dav = DavidsonSolver(tol=1e-7)
                    dvals, dvecs = dav.solve(
                        lambda v: M @ v, self.h.diagonal_np(basis), v0=v0)
                    if dav.converged:
                        e, vec = float(dvals[0]), dvecs[:, 0]
                if e is None:
                    vals, vecs = lowest_pairs(M, v0=v0, tol=1e-10)
                    e, vec = float(vals[0]), vecs[:, 0]
            else:
                vals, vecs = lowest_pairs(M)
                e, vec = float(vals[0]), vecs[:, 0]
        else:
            vals, vecs = self.h.exact_ground_state(basis, k=1, v0=v0)
            e, vec = float(vals[0]), vecs[:, 0]
        self._last_coeffs = vec
        if len(self._diag_cache) > 4:
            self._diag_cache.clear()
        self._diag_cache[fp] = (e, vec)
        return e, vec

    # ------------------------------------------------------------------
    # PT2 scoring
    # ------------------------------------------------------------------

    def _pt2_topk_device(self, src: np.ndarray, src_c: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Device block: connections of all sources, their keys
        (``Hamiltonian.keys_device``: one int64 up to two words, an
        (alpha, beta) pair at four), the signed coupling of every unique
        key, and the top K keys by coupling^2.  Returns host (cand (K', W)
        uint32, coupling (K',) float64), one row per key of a block.

        A block's partial couplings of a key add up in the host's grouped
        sum, so the merge over blocks is exact; :func:`_sum_by_key` makes
        two calls bit-equal on a card.  The top K is a stable descending
        sort: an exact top-k whose ties keep the lower key, as the JAX
        package's top-k does on the CPU.  With ``pt2_sort_rows`` a block
        first keeps its rows of largest |c_j H_ij| the same way (ties keep
        the lower row).  With a mesh each block's rows split over its
        entries (:meth:`_shards`), each shard keeping its own top K, as
        the JAX package's ``shard_map`` does."""
        h = self.h
        dev = h.device
        C = h.n_connections
        c = self.config
        if self._pt2_row_cap is None:
            from ..utils.memory import MemoryBudget
            self._pt2_row_cap = MemoryBudget.for_device(dev).pt2_score_rows(
                C, h.pack_words)
        # K covers every internal det (<= max_basis_size) that can crowd
        # the coupling^2 ranking, plus a wide margin of externals for the
        # final rescore with the |E - E_i| denominator
        K_max = c.max_basis_size + 16 * c.configs_per_iteration
        cap_rows = int(c.pt2_sort_rows)
        if cap_rows:
            K_max = min(K_max, cap_rows)
        def block(h_d, rows_np, coeff_np):
            """One block (or mesh shard) on ``h_d.device``: host keys and
            float64 couplings of its top K_max keys."""
            dev = h_d.device
            rows = to_device(rows_np, dev)
            coeff = torch.as_tensor(coeff_np, dtype=torch.float32,
                                    device=dev)
            conn, elems = h_d.connections_device(rows)
            contrib = (elems * coeff[:, None]).reshape(-1)
            key = h_d.keys_device(conn).flatten(0, 1)
            del conn, elems
            if cap_rows and contrib.numel() > cap_rows:
                sel = torch.sort(contrib.abs(), descending=True,
                                 stable=True).indices[:cap_rows]
                contrib, key = contrib[sel], key[sel]
            key, coupling = _sum_by_key(key, contrib)
            idx = torch.sort(coupling * coupling, descending=True,
                             stable=True).indices[:K_max]
            return (h_d.keys_to_host(key[idx]),
                    coupling[idx].double().cpu().numpy())

        keys, couplings = [], []
        for i in range(0, len(src), self._pt2_row_cap):
            blk = slice(i, i + self._pt2_row_cap)
            for h_d, rows in self._shards(src[blk]):
                k, cp = block(h_d, src[blk][rows], src_c[blk][rows])
                keys.append(k)
                couplings.append(cp)
        return h.unkey(np.concatenate(keys)), np.concatenate(couplings)

    def _shards(self, rows: np.ndarray):
        """[(Hamiltonian on a device, row slice)]: the whole block on the
        Hamiltonian's device, or with a mesh one contiguous slice of
        ceil(B / size) rows an entry, on that entry's device (empty slices
        dropped)."""
        if self.mesh is None or self.mesh.size == 1:
            return [(self.h, slice(0, len(rows)))]
        per = -(-len(rows) // self.mesh.size)
        return [(self.h.on(dev), slice(d * per, (d + 1) * per))
                for d, dev in enumerate(self.mesh.devices)
                if d * per < len(rows)]

    def _pt2_candidates(self, basis: np.ndarray, coeffs: np.ndarray,
                        energy: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (candidate dets (M, W), PT2 scores (M,)).  Under the
        profiler it is the span ``sci.score`` (it ends in host reads) and
        counts ``sci.rounds``, and ``sci.device_rounds`` where the device
        block scored."""
        t0 = time.perf_counter()
        try:
            with span("sci.score"):
                return self._pt2_candidates_timed(basis, coeffs, energy)
        finally:
            self.timings["score"] += time.perf_counter() - t0

    def _pt2_candidates_timed(self, basis: np.ndarray, coeffs: np.ndarray,
                              energy: float
                              ) -> Tuple[np.ndarray, np.ndarray]:
        c = self.config
        sig = np.abs(coeffs) > c.coefficient_threshold
        if not sig.any():
            sig = np.abs(coeffs) >= np.abs(coeffs).max()
        src = basis[sig]
        src_c = coeffs[sig]

        if c.source_screen > 0.0 and len(src) > 1:
            # a row j with |c_j| * Hmax below the selection cutoff cannot
            # by itself push a candidate over it: skip scoring it
            if self._hmax is None:
                sample = src[:: max(1, len(src) // 256)][:256]
                _, elems = self.h.connections_np(sample)
                self._hmax = float(np.abs(elems).max())
            c_min = (c.source_screen * c.residual_threshold
                     / max(self._hmax, 1e-12))
            scr = np.abs(src_c) >= c_min
            if scr.any() and not scr.all():
                src, src_c = src[scr], src_c[scr]

        use_device = self.use_device_scoring
        if use_device is None:
            use_device = (len(src) * self.h.n_connections
                          >= self.DEVICE_SCORING_MIN_ELEMS)

        count("sci.rounds")
        if use_device:
            count("sci.device_rounds")
            cand_all, coupling_all = self._pt2_topk_device(src, src_c)
            keys = self.h.keys(cand_all)
            # grouped SUM per key: a block returns one row per key, and
            # per-block partial couplings of one key add up to the exact
            # coupling
            uniq, first_idx, inverse = _sorted_unique(keys,
                                                      return_inverse=True)
            coupling_all = np.bincount(inverse, weights=coupling_all,
                                       minlength=len(uniq))
            cand_all = cand_all[first_idx]
            keys = uniq
        else:
            conn, elems = self.h.connections_np(src)      # (S,C,2), (S,C)
            flat = conn.reshape(-1, conn.shape[-1])
            contrib = (elems * src_c[:, None]).reshape(-1)  # c_j * <i|H|j>
            keys_f = self.h.keys(flat)
            uniq_keys, first_idx, inverse = _sorted_unique(
                keys_f, return_inverse=True)
            coupling_all = np.bincount(inverse, weights=contrib,
                                       minlength=len(uniq_keys))
            cand_all = flat[first_idx]
            keys = uniq_keys

        basis_keys = np.sort(self.h.keys(basis))
        pos = np.clip(np.searchsorted(basis_keys, keys), 0,
                      len(basis_keys) - 1)
        external = (basis_keys[pos] != keys) & (coupling_all != 0.0)

        cand = cand_all[external]
        coupling = coupling_all[external]
        if len(cand) == 0:
            return np.empty((0, basis.shape[1]), np.uint32), np.empty(0)

        diag = self.h.diagonal_np(cand)
        denom = np.abs(energy - diag) + 1e-12
        scores = coupling ** 2 / denom
        return cand, scores

    def rank_external_candidates(self, basis: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray, float,
                                            np.ndarray]:
        """Diagonalize ``basis`` and PT2-rank its external candidates:
        (candidates (M, W), scores (M,), variational energy, ground
        coefficients).  The restricted-SKQD subspace builder
        (``krylov/skqd.py``) calls it."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        e, coeffs = self._diagonalize(basis)
        cand, scores = self._pt2_candidates(basis, coeffs, e)
        return cand, scores, e, coeffs

    def expand_basis(self, basis: np.ndarray,
                     n_add: Optional[int] = None) -> Dict:
        """One expansion round with variational rejection; adds up to
        ``n_add`` determinants (``configs_per_iteration`` when None or
        0)."""
        c = self.config
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        e0, coeffs = self._diagonalize(basis)

        n_add = n_add or c.configs_per_iteration
        room = c.max_basis_size - len(basis)
        n_add = max(0, min(n_add, room))
        if n_add == 0:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "reason": "basis at capacity"}

        cand, scores = self._pt2_candidates(basis, coeffs, e0)
        keep = scores > c.residual_threshold ** 2
        cand, scores = cand[keep], scores[keep]
        if len(cand) == 0:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "reason": "no candidates above threshold"}

        top = np.argsort(-scores)[:n_add]
        new_basis = np.concatenate([basis, cand[top]], axis=0)
        e1, _ = self._diagonalize(new_basis)

        if e1 > e0 + 1e-10:
            # variational violation: adding states must not raise the energy
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "reason": "variational violation",
                    "rejected_energy": e1}
        return {"basis": new_basis, "energy": e1, "n_added": int(len(top)),
                "accepted": True, "pt2_correction": float(scores[top].sum())}


    # ------------------------------------------------------------------
    # Exact second-order correction of the converged variational state
    # ------------------------------------------------------------------

    def _pt2_correction_host(self, basis: np.ndarray, coeffs: np.ndarray,
                             energy: float) -> Dict:
        """The exact dE2 in vectorized f64 NumPy (the JAX package's host
        closure): every connection of every basis row, grouped by key."""
        h = self.h
        conn, elems = h.connections_np(basis)
        flat = conn.reshape(-1, conn.shape[-1])
        contrib = (elems * coeffs[:, None]).reshape(-1)
        uniq, first_idx, inverse = _sorted_unique(h.keys(flat),
                                                  return_inverse=True)
        coupling = np.bincount(inverse, weights=contrib, minlength=len(uniq))
        bk = np.sort(h.keys(basis))
        pos = np.clip(np.searchsorted(bk, uniq), 0, len(bk) - 1)
        ext = (bk[pos] != uniq) & (coupling != 0.0)
        diag = h.diagonal_np(flat[first_idx][ext])
        de2 = float(np.sum(coupling[ext] ** 2 / (energy - diag)))
        return {"de2": de2, "corrected_energy": energy + de2,
                "n_external": int(ext.sum()), "exact": True}

    def _pt2_correction_block(self, src: np.ndarray, src_c: np.ndarray,
                              basis_keys: torch.Tensor, cap: int, h=None):
        """One source block on the device: all connections, one int64 key
        each, a stable sort, the signed coupling of every unique key, the
        externals by ``searchsorted`` against the sorted basis keys, an
        exact descending sort by coupling^2 and its top ``cap`` rows.
        Returns (keys, couplings, scores, number of weighted externals);
        :func:`_sum_by_key` makes two calls bit-equal.  ``h`` is the
        Hamiltonian on the block's device (a mesh shard's), by default
        the expander's."""
        h = h or self.h
        dev = h.device
        conn, elems = h.connections_device(to_device(src, dev))
        coeff = torch.as_tensor(src_c, dtype=torch.float32, device=dev)
        contrib = (elems * coeff[:, None]).reshape(-1)
        key = h.keys_device(conn).reshape(-1)
        del conn, elems
        key, coupling = _sum_by_key(key, contrib)
        pos = torch.searchsorted(basis_keys, key).clamp_(
            max=len(basis_keys) - 1)
        score = torch.where(basis_keys[pos] != key, coupling * coupling,
                            torch.zeros_like(coupling))
        n_valid = int((score > 0).sum())
        score, idx = torch.sort(score, descending=True, stable=True)
        idx = idx[:cap]
        return key[idx], coupling[idx], score[:cap], n_valid

    def pt2_correction(self, basis: np.ndarray, coeffs: np.ndarray,
                       energy: float, cap: int = 1 << 23,
                       pad_to: int = 0) -> Dict:
        """Exact Epstein-Nesbet dE2 = sum_k <k|H|Phi>^2 / (E_var - H_kk)
        over all determinants k outside ``basis``: the quantity SHCI/HCI
        report as E_var + dE2 when a Selected-CI expansion exhausts.  The
        PT2 scoring only ranks candidates from significant sources; this
        sums every external coupling from every source.

        Device path: the basis goes through
        :meth:`_pt2_correction_block` in source blocks of half the scoring
        row budget (the block's second sort rides on the scoring
        footprint); each block returns its top ``cap`` external rows by
        coupling^2, per-block partial couplings of a key add up on the
        host, and the sum finishes in f64 with the host diagonal.
        ``exact`` is False only if a block had more than ``cap`` weighted
        external rows: raise ``cap`` and rerun.  A row budget of 0
        (``_pt2_row_cap``) takes the host f64 path.

        4-word determinants (more than 32 orbitals) take
        :meth:`_pt2_correction_multiword`.

        ``pad_to`` pinned the JAX package's compiled block shape across a
        growth loop; eager torch compiles nothing, so it is accepted and
        ignored.  With a mesh each block's source rows split over its
        entries (:meth:`_shards`), each shard with its own top ``cap``, and
        the host sums the shards' partial couplings as it sums blocks.

        The whole sum is the span ``residual.pt2``; it counts
        ``pt2.externals`` and, when device blocks scored, ``pt2.device``."""
        del pad_to
        with span("residual.pt2"):
            out = self._pt2_correction(basis, coeffs, energy, cap)
        count("pt2.externals", out["n_external"])
        return out

    def _pt2_correction(self, basis: np.ndarray, coeffs: np.ndarray,
                        energy: float, cap: int) -> Dict:
        h = self.h
        C = h.n_connections
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        coeffs = np.asarray(coeffs, np.float64)
        S = len(basis)
        if self._pt2_row_cap is None:
            from ..utils.memory import MemoryBudget
            self._pt2_row_cap = MemoryBudget.for_device(
                h.device).pt2_score_rows(C, h.pack_words)
        if not self._pt2_row_cap:
            return self._pt2_correction_host(basis, coeffs, energy)
        count("pt2.device")
        if h.pack_words == 4:
            return self._pt2_correction_multiword(basis, coeffs, energy, cap)

        S_blk = max(64, min(self._pt2_row_cap // 2,
                            1 << (max(S, 1) - 1).bit_length()))
        cap = int(min(cap, S_blk * C))
        # unpadded: an exact searchsorted needs no sentinel
        basis_keys = torch.sort(h.keys_device(
            to_device(basis, h.device)))[0]

        exact = True
        key_parts, coup_parts = [], []
        keys_on = {}
        for i in range(0, S, S_blk):
            src, src_c = basis[i:i + S_blk], coeffs[i:i + S_blk]
            for h_d, rows in self._shards(src):
                bk = keys_on.get(h_d.device)
                if bk is None:
                    bk = keys_on[h_d.device] = basis_keys.to(h_d.device)
                key_s, coup_s, score_s, n_valid = self._pt2_correction_block(
                    src[rows], src_c[rows], bk, cap, h=h_d)
                exact = exact and n_valid <= cap
                valid = score_s > 0.0
                key_parts.append(h.keys_to_host(key_s[valid]))
                coup_parts.append(coup_s[valid].double().cpu().numpy())

        keys = np.concatenate(key_parts)
        coupling = np.concatenate(coup_parts)
        if len(key_parts) > 1 and len(keys):
            # grouped sum of the per-block partial couplings (exact: a
            # block gives at most one row per key)
            order = np.argsort(keys, kind="stable")
            keys, coupling = keys[order], coupling[order]
            firsts = np.flatnonzero(np.concatenate(
                [[True], keys[1:] != keys[:-1]]))
            coupling = np.add.reduceat(coupling, firsts)
            keys = keys[firsts]
        diag = h.diagonal_np(h.unkey(keys))
        de2 = float(np.sum(coupling ** 2 / (energy - diag)))
        return {"de2": de2, "corrected_energy": energy + de2,
                "n_external": int(len(keys)), "exact": exact}

    def _pt2_correction_multiword(self, basis: np.ndarray,
                                  coeffs: np.ndarray, energy: float,
                                  cap: int) -> Dict:
        """The exact dE2 over 4-word determinants (33..64 orbitals).

        A block's key pairs have no one-key ``searchsorted`` against the
        basis, so each block sums its couplings by key pair
        (:func:`_sum_by_key`), sorts them by coupling^2 (stable,
        descending) and returns its top ``cap + |basis|`` rows: the
        |basis| margin means basis rows crowding the top never displace an
        external one.  The host groups the per-block partial couplings by
        ``KEY128`` and drops the rows in the basis.  ``exact`` is True only
        when every block's weighted rows all fit in its window.

        The sum is float64 end to end: the elements come from the float64
        form of the connection function, and each fetched row's H_kk is
        computed on the device in float64 (``diagonal_device(dtype=
        float64)``) from the rows the block already holds.  The JAX
        package took float32 elements and the float32 device diagonal (a
        known fault of 1e-5 to 1e-4 Ha a denominator); a host
        ``diagonal_np`` over 10^8 rows would take too long.

        With a mesh each block's rows split over its entries
        (:meth:`_shards`), each shard with its own window; the JAX
        package's mesh branch here is broken (its row count and its
        ``out_specs`` arity), so the sharded sum is held to this one on
        a single device."""
        C = self.h.n_connections
        S = len(basis)
        S_blk = max(64, min(self._pt2_row_cap // 2,
                            1 << (max(S, 1) - 1).bit_length()))
        exact = True
        key_parts, coup_parts, diag_parts = [], [], []
        for i in range(0, S, S_blk):
            src, src_c = basis[i:i + S_blk], coeffs[i:i + S_blk]
            for h_d, rows in self._shards(src):
                n_rows = len(src[rows])
                fetch = int(min(cap + S, n_rows * C))
                k, cp, dg, ok = self._multiword_block(
                    h_d, src[rows], src_c[rows], fetch)
                exact = exact and ok
                key_parts.append(k)
                coup_parts.append(cp)
                diag_parts.append(dg)

        keys = np.concatenate(key_parts)
        coupling = np.concatenate(coup_parts)
        diag_all = np.concatenate(diag_parts)
        # grouped sum of the per-block partial couplings, then the
        # externality filter: the sorted basis keys are searched in the
        # unique candidates (|basis| searches, not one per candidate)
        uniq, first_idx, inverse = _sorted_unique(keys, return_inverse=True)
        coupling = np.bincount(inverse, weights=coupling,
                               minlength=len(uniq))
        diag = diag_all[first_idx]
        ext = coupling != 0.0
        if len(uniq):
            bk = np.sort(self.h.keys(basis))
            pos = np.searchsorted(uniq, bk)
            in_range = pos < len(uniq)
            pos_v = pos[in_range]
            ext[pos_v[uniq[pos_v] == bk[in_range]]] = False
        de2 = float(np.sum(coupling[ext] ** 2 / (energy - diag[ext])))
        return {"de2": de2, "corrected_energy": energy + de2,
                "n_external": int(ext.sum()), "exact": exact}

    def _multiword_block(self, h, src: np.ndarray, src_c: np.ndarray,
                         fetch: int):
        """One block (or mesh shard) of the multiword dE2 on ``h.device``:
        (host keys, float64 couplings, float64 diagonals of its top
        ``fetch`` rows by coupling^2, True when every weighted row fits)."""
        dev = h.device
        conn_f64 = self._conn_f64.get(dev)
        if conn_f64 is None:
            from ..ops.slater import make_connection_fn_w2
            conn_f64 = self._conn_f64[dev] = make_connection_fn_w2(
                h.tables, dev, dtype=torch.float64)
        conn, elems = conn_f64(to_device(src, dev))
        coeff = torch.as_tensor(src_c, dtype=torch.float64, device=dev)
        contrib = (elems * coeff[:, None]).reshape(-1)
        key = h.keys_device(conn).flatten(0, 1)
        del conn, elems
        key, coupling = _sum_by_key(key, contrib)
        score = coupling * coupling
        n_valid = int((score > 0).sum())
        idx = torch.sort(score, descending=True,
                         stable=True).indices[:min(fetch, n_valid)]
        key, coupling = key[idx], coupling[idx]
        del score, idx
        rows = h.unkey_device(key)
        diag = torch.cat([h.diagonal_device(rows[j:j + (1 << 20)],
                                            dtype=torch.float64)
                          for j in range(0, max(len(rows), 1), 1 << 20)])
        return (h.keys_to_host(key), coupling.cpu().numpy(),
                diag.cpu().numpy(), n_valid <= fetch)


class ResidualBasedExpander:
    """Raw-residual selection: r_i = max_j |c_j <i|H|j>| over the
    significant sources, one row per external configuration (the largest),
    the top ``n_add`` above ``residual_threshold`` added a round, with
    variational rejection.  Host f64 throughout, as in the JAX package."""

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[ResidualExpansionConfig] = None):
        self.h = hamiltonian
        self.config = config or ResidualExpansionConfig()

    def find_residual_configs(self, basis: np.ndarray, coeffs: np.ndarray,
                              n_add: int) -> np.ndarray:
        c = self.config
        basis = np.atleast_2d(basis)
        sig = np.abs(coeffs) > c.coefficient_threshold
        if not sig.any():
            return np.empty((0, basis.shape[1]), np.uint32)
        conn, elems = self.h.connections_np(basis[sig])
        flat = conn.reshape(-1, conn.shape[-1])
        resid = np.abs(elems * coeffs[sig][:, None]).reshape(-1)

        keys = self.h.keys(flat)
        basis_keys = np.sort(self.h.keys(basis))
        pos = np.clip(np.searchsorted(basis_keys, keys), 0,
                      len(basis_keys) - 1)
        ext = basis_keys[pos] != keys
        keys, flat, resid = keys[ext], flat[ext], resid[ext]
        if len(keys) == 0:
            return np.empty((0, basis.shape[1]), np.uint32)

        # keep-max dedup
        order = np.lexsort((-resid, keys))
        keys_s, flat_s, resid_s = keys[order], flat[order], resid[order]
        first = np.concatenate([[True], keys_s[1:] != keys_s[:-1]])
        cand, r = flat_s[first], resid_s[first]
        keep = r > c.residual_threshold
        cand, r = cand[keep], r[keep]
        top = np.argsort(-r)[:n_add]
        return cand[top]

    def expand_basis(self, basis: np.ndarray,
                     n_add: Optional[int] = None) -> Dict:
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        vals, vecs = self.h.exact_ground_state(basis, k=1)
        e0, coeffs = float(vals[0]), vecs[:, 0]
        n_add = n_add or self.config.configs_per_iteration
        cand = self.find_residual_configs(basis, coeffs, n_add)
        if len(cand) == 0:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False}
        new_basis = np.concatenate([basis, cand], axis=0)
        e1 = float(self.h.exact_ground_state(new_basis, k=1)[0][0])
        if e1 > e0 + 1e-10:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "rejected_energy": e1}
        return {"basis": new_basis, "energy": e1, "n_added": int(len(cand)),
                "accepted": True}


def iterative_residual_expansion(hamiltonian: Hamiltonian,
                                 initial_basis: np.ndarray,
                                 config: Optional[ResidualExpansionConfig] = None,
                                 use_pt2: bool = True,
                                 verbose: bool = False,
                                 mesh=None,
                                 pt2_correct: bool = False,
                                 pt2_cap: Optional[int] = None,
                                 pt2_checkpoints: Optional[list] = None
                                 ) -> Dict:
    """Loop expansion rounds with stagnation-based early stopping.

    ``use_pt2`` picks the PT2-scored :class:`SelectedCIExpander` (whose
    rounds grow by ``config.growth_factor`` when it is set), else the
    raw-residual :class:`ResidualBasedExpander` (fixed rounds, no
    checkpoints, no dE2).  ``pt2_correct`` adds the exact Epstein-Nesbet dE2 of the final state
    (``pt2_de2``, ``pt2_corrected_energy``, ``pt2_n_external``,
    ``pt2_exact``).  ``pt2_checkpoints``: ascending basis sizes at which
    to also run it mid-trajectory and record (basis_size, e_var, de2,
    exact), the raw points of the SHCI E-against-dE2 extrapolation."""
    cfg = config or ResidualExpansionConfig()
    basis = np.atleast_2d(np.asarray(initial_basis, np.uint32))
    # never let a large seed basis turn expansion into a no-op — but only
    # when the seed actually crowds the cap
    if cfg.max_basis_size < len(basis) + cfg.configs_per_iteration:
        needed = len(basis) + cfg.max_iterations * cfg.configs_per_iteration
        cfg = dataclasses.replace(cfg, max_basis_size=needed)
    expander = (SelectedCIExpander(hamiltonian, cfg, mesh=mesh) if use_pt2
                else ResidualBasedExpander(hamiltonian, cfg))
    energies = []
    best_energy = np.inf
    best_basis = basis
    stall = 0
    checkpoints = sorted(pt2_checkpoints or [])
    checkpoint_rows = []

    def maybe_checkpoint(b):
        """Exact dE2 snapshots whenever the basis crosses a checkpoint."""
        while checkpoints and len(b) >= checkpoints[0]:
            target = checkpoints.pop(0)
            e_c, c_c = expander._diagonalize(b)       # fingerprint-cached
            corr = expander.pt2_correction(b, c_c, e_c,
                                           cap=pt2_cap or (1 << 23))
            row = {"basis_size": int(len(b)), "checkpoint": int(target),
                   "e_var": float(e_c), "de2": float(corr["de2"]),
                   "exact": bool(corr["exact"])}
            checkpoint_rows.append(row)
            if verbose:
                print(f"  [pt2 checkpoint] basis={row['basis_size']} "
                      f"E={row['e_var']:.8f} dE2={row['de2']:.6f} "
                      f"exact={row['exact']}")

    for it in range(cfg.max_iterations):
        n_add = None
        if use_pt2 and cfg.growth_factor > 0:
            n_add = max(cfg.configs_per_iteration,
                        int(cfg.growth_factor * len(basis)))
        out = expander.expand_basis(basis, n_add=n_add)
        e = out["energy"]
        energies.append(e)
        if e < best_energy - 1e-12:
            improvement = best_energy - e
            best_energy, best_basis = e, out["basis"]
        else:
            improvement = 0.0
        basis = out["basis"]
        if verbose:
            t = getattr(expander, "timings", None)
            split = (f" [diag {t['diag']:.0f}s score {t['score']:.0f}s]"
                     if t else "")
            print(f"  residual iter {it}: E={e:.8f} "
                  f"basis={len(basis)} added={out['n_added']} "
                  f"accepted={out['accepted']}{split}")
        if not out["accepted"]:
            break
        if use_pt2:
            maybe_checkpoint(basis)
        if improvement < cfg.stagnation_threshold:
            stall += 1
            if stall >= cfg.stagnation_patience:
                break
        else:
            stall = 0
    if verbose and use_pt2:
        t = expander.timings
        print(f"  [sci timings] diag {t['diag']:.1f} s "
              f"(H-build {t['diag_build']:.1f} s), "
              f"pt2-score {t['score']:.1f} s")
    res = {"basis": best_basis, "energy": best_energy,
           "energies": energies, "n_iterations": len(energies)}
    if checkpoint_rows:
        res["pt2_checkpoints"] = checkpoint_rows
    if pt2_correct and use_pt2:
        # exact Epstein-Nesbet dE2 of the converged variational state (the
        # final-basis diagonalization hits the fingerprint cache)
        e_b, c_b = expander._diagonalize(best_basis)
        corr = expander.pt2_correction(best_basis, c_b, e_b,
                                       cap=pt2_cap or (1 << 23))
        res.update(pt2_de2=corr["de2"],
                   pt2_corrected_energy=corr["corrected_energy"],
                   pt2_n_external=corr["n_external"],
                   pt2_exact=corr["exact"])
    return res
