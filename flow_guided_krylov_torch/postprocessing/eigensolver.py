"""Eigensolvers: the host float64 Davidson and the device Lanczos ladder.

Counterpart of ``flow_guided_krylov_tpu/postprocessing/eigensolver.py``:

* :class:`DavidsonSolver` — a copy of the host float64 solver.  Final
  projected-Hamiltonian eigensolves stay float64 on the host.
* :func:`solve_generalized_eigenvalue`, :func:`regularize_overlap_matrix`
  and :func:`adaptive_eigensolver` — copies of the host SciPy routines
  (Hv = E S v, overlap clamping, size-based routing whose middle arm is
  the Davidson above).
* :func:`lanczos_ground_state` — m-step Lanczos with full
  reorthogonalization over a dense float32 H (``torch.matmul``).
* :func:`lanczos_ground_state_ell` — the same over (C, N) ELL tables; its
  matvec is ``ops/ell_spmv.ell_spmv``, so on a card it is the hand-written
  kernel at B = 1.  ``restarts`` reseed the solve with its own Ritz vector.
* :func:`lanczos_ground_state_stepped` — two-pass Lanczos that stores no
  Krylov block, for spaces whose tables do not fit the device.
* :func:`exact_fullspace_ground_state` — the full 2^n spin space: identity
  ELL tables built on the device (:func:`_build_fullspace_ell_device`) or
  the table-free flip product, then a host float64 refine.

Every Lanczos vector is float32 on the device of its inputs; the small
tridiagonal is diagonalized there, in float64, with
``torch.linalg.eigh``.  The JAX package's host-streamed variant routed
around a limit of its TPU worker and is not carried: the route is chosen
by memory alone, and a device failure raises.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..ops.ell_spmv import ell_spmv

__all__ = ["solve_generalized_eigenvalue", "regularize_overlap_matrix",
           "DavidsonSolver", "adaptive_eigensolver", "lanczos_ground_state",
           "lanczos_ground_state_ell", "lanczos_ground_state_mv",
           "lanczos_ground_state_stepped",
           "full_diagonal_device", "exact_fullspace_ground_state"]


def solve_generalized_eigenvalue(H: np.ndarray,
                                 S: Optional[np.ndarray] = None,
                                 k: int = 1,
                                 which: str = "SA",
                                 regularization: float = 0.0
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Solve H v = E S v for the lowest-k eigenpairs (host float64)."""
    H = np.asarray(H, np.float64)
    n = H.shape[0]
    H = 0.5 * (H + H.T)
    if regularization > 0:
        H = H + regularization * np.eye(n)
    if S is None:
        if n <= 2048 or k >= n - 1:
            vals, vecs = np.linalg.eigh(H)
            return vals[:k], vecs[:, :k]
        vals, vecs = spla.eigsh(sp.csr_matrix(H), k=k, which=which)
        idx = np.argsort(vals)
        return vals[idx], vecs[:, idx]
    S = 0.5 * (np.asarray(S, np.float64) + np.asarray(S, np.float64).T)
    S = regularize_overlap_matrix(S)
    vals, vecs = sla.eigh(H, S)
    return vals[:k], vecs[:, :k]


def regularize_overlap_matrix(S: np.ndarray,
                              threshold: float = 1e-10) -> np.ndarray:
    """Clamp overlap eigenvalues to >= threshold."""
    vals, vecs = np.linalg.eigh(S)
    vals = np.maximum(vals, threshold)
    return (vecs * vals) @ vecs.T


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


def adaptive_eigensolver(H, k: int = 1, dense_threshold: int = 500,
                         davidson_threshold: int = 5000
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Route by size: dense eigh < 500, Davidson < 5000, else sparse eigsh."""
    if sp.issparse(H):
        n = H.shape[0]
        if n < dense_threshold:
            return solve_generalized_eigenvalue(H.toarray(), k=k)
        vals, vecs = spla.eigsh((H + H.T) * 0.5, k=k, which="SA")
        idx = np.argsort(vals)
        return vals[idx][:k], vecs[:, idx][:, :k]
    H = np.asarray(H, np.float64)
    n = H.shape[0]
    if n < dense_threshold:
        return solve_generalized_eigenvalue(H, k=k)
    if n < davidson_threshold:
        Hs = 0.5 * (H + H.T)
        if k > 1:
            # DavidsonSolver is single-pair; keep k>1 consistent with the
            # dense/eigsh branches by routing to eigsh
            vals, vecs = spla.eigsh(sp.csr_matrix(Hs), k=k, which="SA")
            idx = np.argsort(vals)
            return vals[idx][:k], vecs[:, idx][:, :k]
        solver = DavidsonSolver()
        vals, vecs = solver.solve(lambda v: Hs @ v, np.diag(Hs), k=k)
        return vals, vecs
    vals, vecs = spla.eigsh(sp.csr_matrix(0.5 * (H + H.T)), k=k, which="SA")
    idx = np.argsort(vals)
    return vals[idx][:k], vecs[:, idx][:, :k]


# ---------------------------------------------------------------------------
# Device Lanczos (float32, full reorthogonalization)
# ---------------------------------------------------------------------------

def _lanczos_tridiag_mv(mv: Callable[[torch.Tensor], torch.Tensor],
                        v0: torch.Tensor, m: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """m-step Lanczos tridiagonalization of a symmetric operator given as
    a matvec closure, with full reorthogonalization (m is small).  Returns
    (V (m, N), alphas (m,), betas (m,)), betas[j] coupling j and j + 1.
    Nothing is read back to the host inside the loop."""
    n = v0.shape[0]
    f32 = dict(dtype=torch.float32, device=v0.device)
    V = torch.zeros((m, n), **f32)
    V[0] = v0 / torch.linalg.norm(v0)
    alphas = torch.zeros(m, **f32)
    betas = torch.zeros(m, **f32)
    for j in range(m):
        vj = V[j]
        w = mv(vj)
        alpha = torch.dot(w, vj)
        w = w - alpha * vj
        Vj = V[:j + 1]
        w = w - (Vj @ w) @ Vj
        beta = torch.linalg.norm(w)
        alphas[j] = alpha
        betas[j] = beta
        # breakdown (invariant subspace): zero the next vector so that T
        # decouples; the last step's vector has no slot
        if j + 1 < m:
            inv = torch.where(beta > 1e-7,
                              1.0 / torch.clamp(beta, min=1e-30),
                              torch.zeros_like(beta))
            V[j + 1] = w * inv
    return V, alphas, betas


def _lanczos_tridiag(h_dense: torch.Tensor, v0: torch.Tensor, m: int):
    """:func:`_lanczos_tridiag_mv` over a dense symmetric H."""
    return _lanczos_tridiag_mv(lambda v: h_dense @ v, v0, m)


def _ritz_ground(V: torch.Tensor, alphas: torch.Tensor, betas: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lowest Ritz pair of the Lanczos run: ``eigh`` of the m x m
    tridiagonal on the vectors' device (a small cuSOLVER call on a card),
    where the JAX package diagonalizes it in the graph.

    The float32 recurrence coefficients are diagonalized in float64: on an
    H100 the float32 cuSOLVER ``eigh`` of N2's 120 x 120 tridiagonal
    (|T| ~ 107 Ha) put the lowest value 2.1e-3 Ha under its float64 one,
    which sits 1.3e-5 Ha from FCI; the CPU's float32 LAPACK loses 1e-5."""
    m = alphas.shape[0]
    a, b = alphas.double(), betas[:m - 1].double()
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    vals, vecs = torch.linalg.eigh(T)
    ground = vecs[:, 0].to(V.dtype) @ V
    return vals[0], ground / torch.linalg.norm(ground)


def lanczos_ground_state(h_dense: torch.Tensor, m: int = 60,
                         v0: Optional[torch.Tensor] = None
                         ) -> Tuple[float, torch.Tensor]:
    """Lowest eigenpair of a dense symmetric float32 H on its device
    (``torch.matmul`` matvecs in full float32).  m ~ 60 steps give
    ground-state energies to ~1e-6 relative."""
    n = h_dense.shape[0]
    m = min(m, n)
    if v0 is None:
        v0 = torch.ones(n, dtype=torch.float32, device=h_dense.device)
    e, v = _ritz_ground(*_lanczos_tridiag(h_dense, v0, m))
    return float(e), v


def lanczos_ground_state_ell(diag: torch.Tensor, elems: torch.Tensor,
                             tgt: torch.Tensor, m: int = 120,
                             v0: Optional[torch.Tensor] = None,
                             restarts: int = 1, rtol: float = 1e-7
                             ) -> Tuple[float, torch.Tensor]:
    """Lowest eigenpair of an ELL-structured H on the tables' device;
    ``elems`` and ``tgt`` use the (C, N) layout of ``ops/ell_spmv.py``.

    The route for conserved sectors and restricted subspaces too large
    for a dense H whose fixed-degree table fits the device.  float32: for
    oracle-grade numbers refine the returned vector on the host (see
    ``SampleBasedKrylovDiagonalization.exact_subspace_energy``).

    ``restarts``: when the (m, N) Krylov block is capped by memory
    (``MemoryBudget.lanczos_ell_m``), depth comes from restarting the
    m-step solve from the previous ground vector.  Stops once a restart
    moves the energy by less than ``rtol`` (one host read per restart).
    """
    return lanczos_ground_state_mv(lambda x: ell_spmv(diag, elems, tgt, x),
                                   diag.shape[0], diag.device, m=m, v0=v0,
                                   restarts=restarts, rtol=rtol)


def lanczos_ground_state_mv(mv: Callable[[torch.Tensor], torch.Tensor],
                            n: int, device, m: int = 120,
                            v0: Optional[torch.Tensor] = None,
                            restarts: int = 1, rtol: float = 1e-7
                            ) -> Tuple[float, torch.Tensor]:
    """:func:`lanczos_ground_state_ell` over any symmetric matvec closure
    on n-vectors of ``device`` (the mesh's row-sharded ELL products)."""
    m = min(m, n)
    if v0 is None:
        v0 = torch.ones(n, dtype=torch.float32, device=device)

    def solve(start):
        e, v = _ritz_ground(*_lanczos_tridiag_mv(mv, start, m))
        return float(e), v

    e, v = solve(v0)
    for _ in range(max(0, restarts - 1)):
        e_new, v = solve(v)
        done = abs(e_new - e) < rtol * max(1.0, abs(e))
        e = e_new
        if done:
            break
    return e, v


# ---------------------------------------------------------------------------
# Exact full-2^n spin-space ground state on one device
# ---------------------------------------------------------------------------

# rows per chunk of the full-space builds: 2^19 states x C connections of
# int64 words and float32 elements (0.3 GB live at C = 24)
_FULLSPACE_CHUNK = 1 << 19


def full_diagonal_device(ham) -> torch.Tensor:
    """(2^n,) float32 diagonal of the full spin space, built on
    ``ham.device`` in chunks from ``diagonal_device`` over arange states,
    written into one preallocated vector."""
    N = 1 << int(ham.n_sites)
    dev = ham.device
    chunk = min(_FULLSPACE_CHUNK, N)
    d = torch.empty(N, dtype=torch.float32, device=dev)
    for start in range(0, N, chunk):
        idx = torch.arange(start, start + chunk, dtype=torch.int64,
                           device=dev)[:, None]
        d[start:start + chunk] = ham.diagonal_device(idx)
    return d


def lanczos_ground_state_stepped(mv: Callable[[torch.Tensor], torch.Tensor],
                                 dim: int, m: int = 40,
                                 v0: Optional[np.ndarray] = None,
                                 restarts: int = 3, rtol: float = 1e-7,
                                 verbose: bool = False, *, device
                                 ) -> Tuple[float, np.ndarray]:
    """Device Lanczos with no stored Krylov block: the three-term
    recurrence keeps (v_prev, v_cur) on ``device``, two scalars a step
    reach the host, and peak memory is about 4 N-vectors whatever ``m``.

    Pass A accumulates the tridiagonal; the host diagonalizes it (f64);
    pass B runs the recurrence again to assemble the Ritz vector
    (two-pass Lanczos).  No reorthogonalization: in float32 ghost pairs
    only slow the extremal pair, and each restart reseeds from the Ritz
    vector.  ``mv`` may close over device tensors (the JAX package
    threaded them as arguments for its remote compiler)."""
    m = min(m, dim)

    def step(v_prev, v_cur, beta_prev):
        w = mv(v_cur)
        alpha = torch.dot(w, v_cur)
        w = w - alpha * v_cur - beta_prev * v_prev
        beta = torch.linalg.norm(w)
        return w / torch.clamp(beta, min=1e-30), alpha, beta

    rng = np.random.default_rng(11)
    v = torch.as_tensor(np.asarray(
        v0 if v0 is not None else rng.standard_normal(dim), np.float32),
        device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    e_prev = None
    for r in range(max(1, restarts)):
        v = v / torch.linalg.norm(v)
        v_start = v                       # kept for pass B (one extra vec)
        v_prev = torch.zeros_like(v)
        alphas = np.zeros(m)
        betas = np.zeros(m)
        k = m
        beta_prev = zero
        v_cur = v_start
        for j in range(m):
            v_next, a, b = step(v_prev, v_cur, beta_prev)
            alphas[j] = float(a)
            betas[j] = float(b)
            if betas[j] < 1e-6:
                k = j + 1
                break
            v_prev, v_cur, beta_prev = v_cur, v_next, b
        T = (np.diag(alphas[:k]) + np.diag(betas[:k - 1], 1)
             + np.diag(betas[:k - 1], -1))
        vals, vecs = np.linalg.eigh(T)
        e = float(vals[0])
        y = vecs[:, 0]
        # pass B: rebuild sum_j y_j q_j by re-running the recurrence
        acc = torch.zeros_like(v_start)
        v_prev = torch.zeros_like(v_start)
        v_cur = v_start
        beta_prev = zero
        for j in range(k):
            acc = acc + float(y[j]) * v_cur
            if j + 1 < k:
                v_next, _, b = step(v_prev, v_cur, beta_prev)
                v_prev, v_cur, beta_prev = v_cur, v_next, b
        v = acc
        if verbose:
            print(f"  [stepped lanczos] restart {r}: E={e:.8f}", flush=True)
        if e_prev is not None and abs(e - e_prev) < rtol * max(1.0, abs(e)):
            e_prev = e
            break
        e_prev = e
    return e_prev, (v / torch.linalg.norm(v)).cpu().numpy()


def _build_fullspace_ell_device(ham) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Identity-basis (diag, elems_t (C, N), tgt_t (C, N)) ELL tables of
    the full 2^n space, built on ``ham.device``: states are arange, and
    the connection's word is the target row (every XOR flip lands back in
    the space), so there is no sort and no search.  Chunks are written
    straight into the preallocated tables."""
    n = int(ham.n_sites)
    N = 1 << n
    if N > 2 ** 31 - 1:
        raise ValueError(f"2^{n} target rows do not fit the tables' int32 "
                         "indices")
    C = int(ham.n_connections)
    dev = ham.device
    conn_fn = ham.connections_device
    chunk = min(_FULLSPACE_CHUNK, N)
    d = torch.empty(N, dtype=torch.float32, device=dev)
    e = torch.empty((C, N), dtype=torch.float32, device=dev)
    t = torch.empty((C, N), dtype=torch.int32, device=dev)
    for start in range(0, N, chunk):
        idx = torch.arange(start, start + chunk, dtype=torch.int64,
                           device=dev)[:, None]
        conn, el = conn_fn(idx)                    # (B, C, 1), (B, C)
        d[start:start + chunk] = ham.diagonal_device(idx)
        e[:, start:start + chunk] = el.T
        t[:, start:start + chunk] = conn[..., 0].T
    return d, e, t


def _fullspace_cache_path(ham):
    """Disk-cache location for the full-space ground energy, keyed by the
    Hamiltonian content (as ``SampleBasedKrylovDiagonalization.
    _oracle_cache_path``; the JAX package's hash and directory).  The
    ``torch_`` prefix keeps the port's oracle apart from the JAX
    package's file of the same hash in the same directory."""
    import hashlib
    import os
    from pathlib import Path
    hsh = hashlib.sha1(b"fullspace")
    hsh.update(type(ham).__name__.encode())
    for attr in ("n_sites", "Jx", "Jy", "Jz", "V", "h", "L", "periodic"):
        hsh.update(repr(getattr(ham, attr, None)).encode())
    for attr in ("h_x", "h_y", "h_z"):
        val = getattr(ham, attr, None)
        if val is not None:
            hsh.update(np.asarray(val, np.float64).tobytes())
    root = Path(os.environ.get(
        "FGK_INTEGRAL_CACHE",
        Path.home() / ".cache" / "fgk_tpu_integrals"))
    return root / f"torch_fullspace_{hsh.hexdigest()}.txt"


def _fullspace_plan(n_sites: int, n_connections: int, total_bytes: int,
                    m: int = 120) -> dict:
    """Route and Lanczos depth of :func:`exact_fullspace_ground_state` for
    2^n_sites states of ``n_connections`` flips on a device of
    ``total_bytes``: ``ell-fused`` (depth ``MemoryBudget.lanczos_ell_m``,
    restarts up to ``m`` steps) when the identity tables, a GiB and ten
    vectors fit 85 % of memory; ``flip-stepped`` (m = 40, at least three
    restarts) when six vectors fit half of it; MemoryError otherwise.
    Memory alone picks the route."""
    from ..utils.memory import MemoryBudget
    dim = 1 << int(n_sites)
    C = int(n_connections)
    tables_bytes = 2 * C * dim * 4 + dim * 4
    if tables_bytes + (1 << 30) + 10 * dim * 4 <= 0.85 * total_bytes:
        m_fit = MemoryBudget(total_bytes).lanczos_ell_m(dim, C, m_max=m)
        return {"route": "ell-fused", "lanczos_m": min(m_fit, dim),
                "restarts": max(1, -(-m // m_fit))}
    # table-free flip route: about six float32 N-vectors live
    if 6 * 4 * dim <= 0.5 * total_bytes:
        return {"route": "flip-stepped", "lanczos_m": min(40, dim),
                "restarts": max(3, -(-m // 40))}
    raise MemoryError(
        f"full 2^{n_sites} ELL tables ({tables_bytes / 2**30:.1f} GiB at "
        f"C={C}) exceed the memory budget ({total_bytes / 2**30:.0f} GiB) "
        "and the table-free route does not fit either")


def exact_fullspace_ground_state(ham, m: int = 120, refine_host: bool = True,
                                 tol: float = 1e-9, verbose: bool = True,
                                 use_cache: bool = True) -> dict:
    """Exact ground state of the full 2^n spin space on ``ham.device``,
    for models no conserved sector shrinks (TFIM, transverse-field
    Heisenberg):

    1. ``ell-fused``: identity-basis ELL tables built on the device
       (:func:`_build_fullspace_ell_device`) and a restarted float32
       Lanczos over the ELL kernel (:func:`lanczos_ground_state_ell`)
       under the memory budget's Krylov block; or ``flip-stepped`` where
       the tables do not fit: the table-free slab-flip product
       (``ham.apply_statevector``) under the block-free two-pass Lanczos.
       Memory alone picks the route.
    2. Host f64 refine: ``eigsh`` seeded with the device vector over the
       host slab product (``ham.apply_statevector_np``), a formulation
       independent of the packed connections, so the refined energy also
       checks the device Hamiltonian.
    """
    from ..utils.memory import device_memory_bytes

    n = int(ham.n_sites)
    dim = 1 << n
    C = int(ham.n_connections)
    dev = ham.device
    plan = _fullspace_plan(n, C, device_memory_bytes(dev), m)
    route, lanczos_m, restarts = (plan["route"], plan["lanczos_m"],
                                  plan["restarts"])

    path = _fullspace_cache_path(ham)
    if use_cache and refine_host:
        try:
            return {"energy": float(path.read_text()), "dim": dim,
                    "cached": True}
        except (OSError, ValueError):
            pass

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    v0 = np.random.default_rng(7).standard_normal(dim).astype(np.float32)
    if route == "flip-stepped":
        diag_dev = full_diagonal_device(ham)
        sync()
        wall_build = time.time() - t0
        t0 = time.time()
        e_dev, v_host = lanczos_ground_state_stepped(
            lambda v: ham.apply_statevector(v, diag_dev), dim, m=lanczos_m,
            v0=v0, restarts=restarts, verbose=verbose, device=dev)
        v_host = v_host.astype(np.float64)
        del diag_dev
    else:
        diag, elems, tgt = _build_fullspace_ell_device(ham)
        sync()
        wall_build = time.time() - t0
        t0 = time.time()
        e_dev, v = lanczos_ground_state_ell(
            diag, elems, tgt, m=lanczos_m,
            v0=torch.as_tensor(v0, device=dev), restarts=restarts)
        v_host = v.double().cpu().numpy()
        del v, diag, elems, tgt
    wall_device = time.time() - t0
    if verbose:
        print(f"  [fullspace] {route} device Lanczos E={e_dev:.8f} "
              f"({wall_device:.1f} s; device build {wall_build:.1f} s)")

    out = {"dim": dim, "n_connections": C, "route": route,
           "lanczos_m": lanczos_m, "restarts": restarts,
           "wall_build_s": round(wall_build, 3),
           "wall_device_s": round(wall_device, 3), "cached": False,
           "e_device": float(e_dev)}
    if not refine_host:
        out["energy"] = float(e_dev)
        return out

    # host f64 seeded refine over the slab statevector matvec
    t0 = time.time()
    diag_np = ham.full_diagonal_np()
    nmv = [0]

    def mv(x):
        nmv[0] += 1
        return ham.apply_statevector_np(x, diag=diag_np)

    op = spla.LinearOperator((dim, dim), matvec=mv, dtype=np.float64)
    v_host /= np.linalg.norm(v_host)
    out["e_rayleigh_f32vec"] = float(v_host @ mv(v_host))
    # a near-converged start needs only a thin restart basis
    vals = spla.eigsh(op, k=1, which="SA", v0=v_host, tol=tol,
                      ncv=min(10, dim - 1), return_eigenvectors=False)
    e = float(vals.min())
    wall_refine = time.time() - t0
    if verbose:
        print(f"  [fullspace] host f64 refine E={e:.10f} "
              f"({nmv[0]} matvecs, {wall_refine:.1f} s)")
    out.update(energy=e, refine_matvecs=nmv[0],
               wall_refine_s=round(wall_refine, 3))
    if use_cache:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(repr(e))
        except OSError:
            pass
    return out
