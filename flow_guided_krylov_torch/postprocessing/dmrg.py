"""Host DMRG oracle for 1-D open-boundary spin chains.

A copy of ``flow_guided_krylov_tpu/postprocessing/dmrg.py`` (NumPy and
SciPy): a matrix-product-state ground-state solver (two-site DMRG, f64,
dense tensors) for the spin Hamiltonians of ``hamiltonians/spin.py``.  It
is the oracle of the Selected-CI runs past enumeration (Heisenberg-32's
S_z = 0 sector holds 601,080,390 states): variational over matrix-product
states, with no Hamiltonian enumeration and no Krylov space, so it shares
no failure with the port's own eigensolvers.

Scope: open boundaries, nearest-neighbour couplings.  A periodic chain
raises rather than being treated as open.

Conventions match ``hamiltonians/spin.py`` (sigma = full Pauli):

- Heisenberg: ``sum_bonds [(Jz/4) z z + ((Jx+Jy)/4)(+ - + - +)]
  + sum_i [(h_z_i/2) z + (h_x_i/2) x]``
- TFIM (L=1): ``-V sum_edges z z - h sum_i x``

The returned ``truncation_error`` (largest discarded Schmidt weight of
the final sweep) bounds the energy bias.  DMRG energies are variational:
E_dmrg >= E_exact.

The on-disk cache names its files ``torch_dmrg_<sha>.json``, so a file the
JAX package wrote (``dmrg_<sha>.json``) is never read.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import scipy.sparse.linalg as spla

__all__ = ["dmrg_ground_state"]


def _cache_path(ws: list, max_bond: int, sweeps: int, tol: float,
                seed: int) -> Path:
    """Disk-cache key: the MPO tensors are the Hamiltonian (every model
    parameter lands in them), so their bytes plus the solver knobs
    identify the run; a 32-site chain at m = 256 costs minutes."""
    hsh = hashlib.sha1(b"dmrg-oracle")
    for w in ws:
        hsh.update(repr(w.shape).encode())
        hsh.update(np.ascontiguousarray(w, np.float64).tobytes())
    hsh.update(repr((max_bond, sweeps, tol, seed)).encode())
    root = Path(os.environ.get(
        "FGK_INTEGRAL_CACHE",
        Path.home() / ".cache" / "fgk_tpu_integrals"))
    return root / f"torch_dmrg_{hsh.hexdigest()}.json"


_ID = np.eye(2)
_SX = np.array([[0.0, 1.0], [1.0, 0.0]])
_SZ = np.array([[1.0, 0.0], [0.0, -1.0]])
_SP = np.array([[0.0, 1.0], [0.0, 0.0]])   # sigma^+
_SM = np.array([[0.0, 0.0], [1.0, 0.0]])   # sigma^-


def _heisenberg_mpo(h) -> list:
    """MPO tensors (wl, wr, s_out, s_in) for the open XXZ chain with
    per-site z/x fields, coefficients exactly as ``connections_np`` /
    ``diagonal_np`` implement them."""
    n = h.n_sites
    a = (h.Jx + h.Jy) / 4.0            # flip-flop coefficient
    b = h.Jz / 4.0                     # zz coefficient
    ws = []
    for i in range(n):
        f = (h.h_z[i] / 2.0) * _SZ + (h.h_x[i] / 2.0) * _SX
        W = np.zeros((5, 5, 2, 2))
        W[0, 0] = _ID
        W[1, 0] = _SP
        W[2, 0] = _SM
        W[3, 0] = _SZ
        W[4, 0] = f
        W[4, 1] = a * _SM
        W[4, 2] = a * _SP
        W[4, 3] = b * _SZ
        W[4, 4] = _ID
        if i == 0:
            W = W[4:5]
        if i == n - 1:
            W = W[:, 0:1]
        ws.append(W)
    return ws


def _tfim_mpo(h) -> list:
    n = h.n_sites
    ws = []
    for i in range(n):
        W = np.zeros((3, 3, 2, 2))
        W[0, 0] = _ID
        W[1, 0] = _SZ
        W[2, 0] = -h.h * _SX
        W[2, 1] = -h.V * _SZ
        W[2, 2] = _ID
        if i == 0:
            W = W[2:3]
        if i == n - 1:
            W = W[:, 0:1]
        ws.append(W)
    return ws


def _build_mpo(hamiltonian) -> list:
    from ..hamiltonians.spin import (HeisenbergHamiltonian,
                                     TransverseFieldIsing)
    if isinstance(hamiltonian, HeisenbergHamiltonian):
        if hamiltonian.periodic:
            raise NotImplementedError(
                "DMRG oracle covers open chains only (periodic records "
                "keep their free-fermion / dense oracles)")
        return _heisenberg_mpo(hamiltonian)
    if isinstance(hamiltonian, TransverseFieldIsing):
        if hamiltonian.periodic:
            raise NotImplementedError(
                "DMRG oracle covers open chains only (periodic TFIM has "
                "the free-fermion oracle)")
        if hamiltonian.L != 1:
            raise NotImplementedError("nearest-neighbour TFIM only")
        return _tfim_mpo(hamiltonian)
    raise TypeError(f"no MPO mapping for {type(hamiltonian).__name__}")


def _contract_left(L, A, W):
    """L (a, w, b) += site: A (ml, s, mr) bra=ket (real MPS)."""
    t = np.tensordot(L, A, axes=(2, 0))            # a w s mr(ket)
    t = np.tensordot(t, W, axes=([1, 2], [0, 3]))  # a mr(ket) wr s_out
    t = np.tensordot(A, t, axes=([0, 1], [0, 3]))  # mr(bra) mr(ket) wr
    return t.transpose(0, 2, 1)                    # a' w' b'


def _contract_right(R, A, W):
    """R (a, w, b) from the right: A (ml, s, mr)."""
    t = np.tensordot(R, A, axes=(2, 2))            # a w ml(ket) s
    t = np.tensordot(t, W, axes=([1, 3], [1, 3]))  # a ml(ket) wl s_out
    t = np.tensordot(A, t, axes=([2, 1], [0, 3]))  # ml(bra) ml(ket) wl
    return t.transpose(0, 2, 1)


def _theta_matvec(L, W1, W2, R, theta):
    """Apply the two-site effective Hamiltonian to theta (bl, s1, s2, br)."""
    t = np.tensordot(L, theta, axes=(2, 0))          # a wl s1 s2 br
    t = np.tensordot(t, W1, axes=([1, 2], [0, 3]))   # a s2 br wr s1'
    t = np.tensordot(t, W2, axes=([3, 1], [0, 3]))   # a br s1' wr2 s2'
    t = np.tensordot(t, R, axes=([3, 1], [1, 2]))    # a s1' s2' ar
    return t


def dmrg_ground_state(hamiltonian, max_bond: int = 256, sweeps: int = 12,
                      tol: float = 1e-9, seed: int = 0,
                      verbose: bool = False) -> Tuple[float, Dict]:
    """Ground-state energy of an open 1-D spin chain by two-site DMRG.

    Returns ``(energy, info)``; ``info`` carries per-sweep energies, the
    final bond dimension and the largest discarded Schmidt weight of the
    last sweep (an error-bar proxy: the energy bias is O(that weight)).
    """
    ws = _build_mpo(hamiltonian)
    n = len(ws)
    if n < 3:
        raise ValueError("chain too short for DMRG; use the dense oracle")

    cache = _cache_path(ws, max_bond, sweeps, tol, seed)
    if cache.exists():
        payload = json.loads(cache.read_text())
        return float(payload["energy"]), payload["info"]

    rng = np.random.default_rng(seed)
    # Neel-biased random product start (the AFM ground state's backbone);
    # the bond-growth schedule below re-entangles it.
    mps = []
    for i in range(n):
        v = np.zeros((1, 2, 1))
        v[0, i % 2, 0] = 1.0
        v[0, :, 0] += 0.05 * rng.normal(size=2)
        v /= np.linalg.norm(v)
        mps.append(v)

    # right environments for the initial right-canonical-ish state:
    # first right-normalize by QR from the right
    for i in range(n - 1, 0, -1):
        ml, d, mr = mps[i].shape
        q, r = np.linalg.qr(mps[i].reshape(ml, d * mr).T.conj())
        k = q.shape[1]
        mps[i] = q.T.conj().reshape(k, d, mr)
        mps[i - 1] = np.tensordot(mps[i - 1], r.T.conj(), axes=(2, 0))

    Rs = [None] * (n + 1)
    Rs[n] = np.ones((1, 1, 1))
    for i in range(n - 1, 1, -1):
        Rs[i] = _contract_right(Rs[i + 1], mps[i], ws[i])
    Ls = [None] * n
    Ls[0] = np.ones((1, 1, 1))

    schedule = [min(32, max_bond), min(64, max_bond), min(128, max_bond)]
    schedule += [max_bond] * max(0, sweeps - 3)

    energies = []
    trunc = 0.0
    e = np.inf
    for sw, m in enumerate(schedule):
        trunc = 0.0
        # left-to-right then right-to-left half sweeps
        for direction in (1, -1):
            sites = range(0, n - 1) if direction == 1 \
                else range(n - 2, -1, -1)
            for i in sites:
                L, R = Ls[i], Rs[i + 2]
                W1, W2 = ws[i], ws[i + 1]
                ml = mps[i].shape[0]
                mr = mps[i + 1].shape[2]
                theta0 = np.tensordot(mps[i], mps[i + 1], axes=(2, 0))
                dim = ml * 2 * 2 * mr

                def mv(x):
                    th = x.reshape(ml, 2, 2, mr)
                    return _theta_matvec(L, W1, W2, R, th).reshape(-1)

                if dim <= 64:
                    H = np.empty((dim, dim))
                    eye = np.eye(dim)
                    for c in range(dim):
                        H[:, c] = mv(eye[c])
                    vals, vecs = np.linalg.eigh((H + H.T) / 2)
                    e_loc, theta = vals[0], vecs[:, 0]
                else:
                    op = spla.LinearOperator((dim, dim), matvec=mv)
                    vals, vecs = spla.eigsh(
                        op, k=1, which="SA", v0=theta0.reshape(-1),
                        tol=max(tol * 1e-2, 1e-12), maxiter=400)
                    e_loc, theta = float(vals[0]), vecs[:, 0]

                theta = theta.reshape(ml * 2, 2 * mr)
                u, s, vt = np.linalg.svd(theta, full_matrices=False)
                keep = min(m, int(np.sum(s > 1e-13)))
                keep = max(keep, 1)
                if len(s) > keep:
                    trunc = max(trunc, float(np.sum(s[keep:] ** 2)))
                u, s, vt = u[:, :keep], s[:keep], vt[:keep]
                s /= np.linalg.norm(s)
                if direction == 1:
                    mps[i] = u.reshape(ml, 2, keep)
                    mps[i + 1] = (s[:, None] * vt).reshape(keep, 2, mr)
                    Ls[i + 1] = _contract_left(Ls[i], mps[i], W1)
                else:
                    mps[i] = (u * s[None, :]).reshape(ml, 2, keep)
                    mps[i + 1] = vt.reshape(keep, 2, mr)
                    Rs[i + 1] = _contract_right(Rs[i + 2], mps[i + 1], W2)
        energies.append(e_loc)
        if verbose:
            print(f"  [dmrg] sweep {sw}: m={m} E={e_loc:.10f} "
                  f"trunc={trunc:.2e}")
        if sw >= 3 and abs(energies[-1] - e) < tol:
            e = e_loc
            break
        e = e_loc

    info = {
        "energies": [float(x) for x in energies],
        "sweeps": len(energies),
        "max_bond": int(max(t.shape[0] for t in mps)),
        "truncation_error": float(trunc),
        # the chain's total magnetization: callers using DMRG as a
        # SECTOR oracle (S_z-conserving chains where Lieb-Mattis puts
        # the global ground state in S_z = 0) can assert it vanishes
        "total_sz": _total_sz(mps),
    }
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps({"energy": float(e), "info": info}))
    return float(e), info


def _total_sz(mps) -> float:
    """<sum_i S^z_i> of a mixed-canonical MPS with centre at site 0."""
    total = 0.0
    A = mps[0]
    for i in range(len(mps)):
        total += 0.5 * float(np.einsum("asb,st,atb->", A, _SZ, A))
        if i < len(mps) - 1:
            ml, d, mr = A.shape
            q, r = np.linalg.qr(A.reshape(ml * d, mr))
            A = np.tensordot(r, mps[i + 1], axes=(1, 0))
    return total
