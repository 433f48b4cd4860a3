"""The port's host sparse eigensolves ask ARPACK for the pairs their
callers read: one where only the lowest is read.

On a translation-closed periodic TFIM-16 basis (every state of Hamming
weight <= 4, 2,517 states: past the 2,048-state dense cut) the lowest
eigenvalue is gapped and the ones above it come in a one-magnon band,
partly twofold degenerate.  A second, unread pair there costs ARPACK
several times the iterations of the one that is read.
"""

from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg
from torch.profiler import ProfilerActivity, profile

from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
from flow_guided_krylov_torch.hamiltonians.spin import pack_spin_state
from flow_guided_krylov_torch.krylov.residual_expansion import \
    SelectedCIExpander
from flow_guided_krylov_torch.krylov.skqd import (
    SampleBasedKrylovDiagonalization, SKQDConfig)
from flow_guided_krylov_torch.utils import profiling
from tests.test_torch_tracing import _independent_matvecs

N, WEIGHT = 16, 4


@pytest.fixture(scope="module")
def chain():
    """(Hamiltonian, basis, symmetrized projected H, its dense eigh)."""
    h = TransverseFieldIsing(N, V=1.0, h=0.5, periodic=True, device="cpu")
    states = np.arange(2 ** N, dtype=np.uint32)
    weight = np.unpackbits(states.view(np.uint8)).reshape(-1, 32).sum(1)
    basis = states[weight <= WEIGHT][:, None]
    assert len(basis) == 2517
    M = h.to_sparse(basis)
    M = ((M + M.T) * 0.5).tocsr()
    vals, vecs = np.linalg.eigh(M.toarray())
    return h, basis, M, vals, vecs


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _skqd(h):
    return SampleBasedKrylovDiagonalization(
        h, SKQDConfig(evolution="trotter"),
        initial_state=pack_spin_state(0, N))


def _skqd_energy(h, basis):
    return _skqd(h).compute_ground_state_energy(basis)


def _exact_energy(h, basis):
    return float(h.exact_ground_state(basis, k=1)[0][0])


def _sci_energy(h, basis):
    # a fresh expander holds no previous vector: the unseeded branch
    return SelectedCIExpander(h)._diagonalize(basis)[0]


SOLVES = {"skqd": _skqd_energy, "exact": _exact_energy, "sci": _sci_energy}


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
