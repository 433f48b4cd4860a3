"""The port's host solves of a projected basis: every one goes through
``hamiltonians/base.py`` (``Hamiltonian.projected`` builds H, dense up to
``DENSE_SOLVE_MAX_ROWS`` states and sparse above, and ``lowest_pairs``
solves it), once a solve, with the JAX package's energy; and the sparse
ones ask ARPACK for the pairs their callers read: one where only the
lowest is read.

On a translation-closed periodic TFIM-16 basis (every state of Hamming
weight <= 4, 2,517 states: past the 2,048-state dense cut) the lowest
eigenvalue is gapped and the ones above it come in a one-magnon band,
partly twofold degenerate.  A second, unread pair there costs ARPACK
several times the iterations of the one that is read.
"""

import functools
import sys
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg
from torch.profiler import ProfilerActivity, profile

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov import residual_expansion as jres
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_torch.convert import spin_hamiltonian_from_jax
from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
from flow_guided_krylov_torch.hamiltonians import base
from flow_guided_krylov_torch.hamiltonians.base import DENSE_SOLVE_MAX_ROWS
from flow_guided_krylov_torch.hamiltonians.spin import pack_spin_state
from flow_guided_krylov_torch.krylov.residual_expansion import (
    ResidualExpansionConfig, SelectedCIExpander)
from flow_guided_krylov_torch.krylov.skqd import (
    SampleBasedKrylovDiagonalization, SKQDConfig)
from flow_guided_krylov_torch.utils import profiling
from tests.test_torch_tracing import _independent_matvecs

N, WEIGHT = 16, 4
# (sites, largest Hamming weight) -> states: one basis a side of the rule
LATTICES = {(12, 4): 794, (14, 5): 3473}


def _low_weight(n, weight):
    """Every n-site state of Hamming weight <= ``weight``, ascending."""
    states = np.arange(2 ** n, dtype=np.uint32)
    ones = np.unpackbits(states.view(np.uint8)).reshape(-1, 32).sum(1)
    return states[ones <= weight][:, None]


@pytest.fixture(scope="module")
def chain():
    """(Hamiltonian, basis, symmetrized projected H, its dense eigh)."""
    h = TransverseFieldIsing(N, V=1.0, h=0.5, periodic=True, device="cpu")
    basis = _low_weight(N, WEIGHT)
    assert len(basis) == 2517
    M = h.to_sparse(basis)
    M = ((M + M.T) * 0.5).tocsr()
    vals, vecs = np.linalg.eigh(M.toarray())
    return h, basis, M, vals, vecs


@functools.lru_cache(maxsize=None)
def _lattice(n, weight):
    """(JAX Hamiltonian, the port's, basis): periodic TFIM, h = 0.5."""
    jh = jspin.TransverseFieldIsing(n, V=1.0, h=0.5, periodic=True)
    basis = _low_weight(n, weight)
    assert len(basis) == LATTICES[n, weight]
    return jh, spin_hamiltonian_from_jax(jh, "cpu"), basis


@pytest.fixture(autouse=True)
def _clean_record(tmp_path, monkeypatch):
    # the subspace oracle's disk cache: one empty directory a test
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    profiling.reset()
    yield
    profiling.reset()


def _skqd(h):
    return SampleBasedKrylovDiagonalization(
        h, SKQDConfig(evolution="trotter"),
        initial_state=pack_spin_state(0, h.n_sites))


def _skqd_energy(h, basis):
    return _skqd(h).compute_ground_state_energy(basis)


def _exact_energy(h, basis):
    return float(h.exact_ground_state(basis, k=1)[0][0])


def _sci_energy(h, basis):
    # a fresh expander holds no previous vector: the unseeded branch
    return SelectedCIExpander(h)._diagonalize(basis)[0]


def _previous(n):
    """A previous round's vector: shorter than the basis it warms."""
    return np.random.default_rng(3).uniform(-1, 1, n - 7)


def _sci_warm_energy(h, basis):
    # Davidson off: the warm branch goes straight to its eigsh
    exp = SelectedCIExpander(h, ResidualExpansionConfig(use_davidson=False))
    exp._last_coeffs = _previous(len(basis))
    return exp._diagonalize(basis)[0]


def _oracle_energy(h, basis):
    # a short device Lanczos: the host refine converges from any start
    return SampleBasedKrylovDiagonalization(
        h, SKQDConfig(), initial_state=pack_spin_state(0, h.n_sites),
        subspace_states=basis).exact_subspace_energy(m=ORACLE_M)


ORACLE_M = 30
SOLVES = {"skqd": _skqd_energy, "exact": _exact_energy, "sci": _sci_energy,
          "sci_warm": _sci_warm_energy, "oracle": _oracle_energy}


def _jax_skqd(jh, **kw):
    return jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(**kw), initial_state=np.zeros(1, np.uint32))


def _jax_sci_warm(jh, basis):
    exp = jres.SelectedCIExpander(
        jh, jres.ResidualExpansionConfig(use_davidson=False))
    exp._last_coeffs = _previous(len(basis))
    return exp._diagonalize(basis)[0]


def _jax_oracle(jh, basis):
    return jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(), initial_state=np.zeros(1, np.uint32),
        subspace_states=basis).exact_subspace_energy(m=ORACLE_M)


# the JAX package's counterpart of each solve
JAX_SOLVES = {
    "skqd": lambda jh, basis: _jax_skqd(
        jh, evolution="trotter").compute_ground_state_energy(basis),
    "exact": lambda jh, basis: float(jh.exact_ground_state(basis, k=1)[0][0]),
    "sci": lambda jh, basis: jres.SelectedCIExpander(jh)._diagonalize(
        basis)[0],
    "sci_warm": _jax_sci_warm, "oracle": _jax_oracle}


def _watch_lowest_pairs(monkeypatch):
    """``lowest_pairs`` noting the matrix of each call, in every module of
    the port that binds it."""
    real, seen = base.lowest_pairs, []

    def watched(M, *args, **kw):
        seen.append(M)
        return real(M, *args, **kw)

    for name, module in list(sys.modules.items()):
        if (name.startswith("flow_guided_krylov_torch.")
                and getattr(module, "lowest_pairs", None) is real):
            monkeypatch.setattr(module, "lowest_pairs", watched)
    return seen


@pytest.mark.parametrize("site, lattice", [
    pytest.param(site, lat, id=f"{site}-tfim{lat[0]}")
    for site in sorted(SOLVES) for lat in sorted(LATTICES)
    # the oracle solves its subspace's sparse H at any size: one suffices
    if site != "oracle" or lat == (12, 4)])
def test_each_site_solves_once_through_lowest_pairs(site, lattice,
                                                    monkeypatch):
    """Every host solve of a projected basis calls ``lowest_pairs`` once,
    on a dense array at 794 states and a sparse matrix at 3,473 (the
    oracle on its subspace's sparse H), and its energy is the JAX
    package's to 1e-12 Ha."""
    jh, h, basis = _lattice(*lattice)
    seen = _watch_lowest_pairs(monkeypatch)
    e = SOLVES[site](h, basis)
    assert len(seen) == 1
    dense = len(basis) <= DENSE_SOLVE_MAX_ROWS and site != "oracle"
    assert isinstance(seen[0], np.ndarray) == dense
    assert abs(e - JAX_SOLVES[site](jh, basis)) < 1e-12


@pytest.mark.parametrize("rows", [DENSE_SOLVE_MAX_ROWS,
                                  DENSE_SOLVE_MAX_ROWS + 1])
def test_dense_sparse_rule_at_its_boundary(chain, rows, monkeypatch):
    """``exact_ground_state`` on the chain's first 2,048 states solves a
    dense array, on 2,049 a sparse matrix: either way the lowest
    eigenvalue of the same block of the projected H to 1e-10."""
    h, basis, M, _, _ = chain
    sub = basis[:rows]
    seen = _watch_lowest_pairs(monkeypatch)
    vals, vecs = h.exact_ground_state(sub, k=1)
    assert len(seen) == 1 and vecs.shape == (rows, 1)
    assert isinstance(seen[0], np.ndarray) == (rows <= DENSE_SOLVE_MAX_ROWS)
    assert sp.issparse(seen[0]) == (rows > DENSE_SOLVE_MAX_ROWS)
    want = np.linalg.eigvalsh(M[:rows, :rows].toarray())[0]
    assert abs(vals[0] - want) < 1e-10


def _watched_eigsh(asked, v0=None):
    """SciPy's ``eigsh`` noting each call's ``k``; with ``v0`` given, that
    start where the caller gives none."""
    real = scipy.sparse.linalg.eigsh

    def watched(A, **kw):
        asked.append(kw.get("k", 6))
        if v0 is not None and kw.get("v0") is None:
            kw["v0"] = v0
        return real(A, **kw)
    return real, watched


@pytest.mark.parametrize("site", sorted(SOLVES))
def test_lowest_pair_asks_for_one(chain, site):
    """Each solve that reads the lowest pair asks ``eigsh`` for one, and
    gets the lowest eigenvalue of the dense solve to 1e-10 (the SKQD
    solve's from its ``regularization``-shifted matrix)."""
    h, basis, M, vals, _ = chain
    asked = []
    _, watched = _watched_eigsh(asked)
    with mock.patch.object(scipy.sparse.linalg, "eigsh", watched):
        e = SOLVES[site](h, basis)
    assert asked == [1]
    if site == "skqd":
        reg = SKQDConfig().regularization
        shifted = M + reg * sp.eye(len(basis))
        want = np.linalg.eigvalsh(shifted.toarray())[0] - reg
    else:
        want = vals[0]
    assert abs(e - want) < 1e-10


@pytest.mark.parametrize("k", [1, 3])
def test_exact_ground_state_returns_the_pairs_asked(chain, k):
    """``exact_ground_state(basis, k)`` asks ``eigsh`` for k pairs and
    returns them ascending: the dense solve's eigenvalues to 1e-10, each
    vector a unit eigenvector (the third lies in a degenerate pair, so
    only the ground vector is unique, up to sign)."""
    h, basis, M, vals, vecs = chain
    asked = []
    _, watched = _watched_eigsh(asked)
    with mock.patch.object(scipy.sparse.linalg, "eigsh", watched):
        got_vals, got_vecs = h.exact_ground_state(basis, k=k)
    assert asked == [k]
    assert got_vals.shape == (k,) and got_vecs.shape == (len(basis), k)
    assert np.all(np.diff(got_vals) >= 0)
    np.testing.assert_allclose(got_vals, vals[:k], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_vecs.T @ got_vecs, np.eye(k),
                               rtol=0, atol=1e-10)
    resid = M @ got_vecs - got_vecs * got_vals
    assert np.max(np.abs(resid)) < 1e-8
    assert abs(abs(got_vecs[:, 0] @ vecs[:, 0]) - 1) < 1e-10


@pytest.mark.parametrize("site", ["exact", "skqd"])
def test_one_pair_takes_a_third_of_the_matvecs(chain, site):
    """Traced with a fixed start, the one-pair solve counts
    ``eigsh.pairs`` 1 and at most a third of the matvecs that two pairs
    take on the same matrix from the same start."""
    h, basis, M, _, _ = chain
    v0 = np.random.default_rng(7).uniform(-1, 1, len(basis))
    asked = []
    real, watched = _watched_eigsh(asked, v0)
    with mock.patch.object(scipy.sparse.linalg, "eigsh", watched):
        with profile(activities=[ProfilerActivity.CPU]):
            SOLVES[site](h, basis)
    counters = profiling.snapshot()["counters"]
    assert asked == [1]
    assert counters["eigsh.pairs"] == 1
    A = M
    if site == "skqd":
        A = M + SKQDConfig().regularization * sp.eye(len(basis))
    two, _ = _independent_matvecs(real, A, 2, v0)
    assert 0 < 3 * counters["eigsh.matvecs"] <= two
