"""Port parity: the device build of a basis-restricted ELL table
(``SampleBasedKrylovDiagonalization._build_ell_device``) against the JAX
package's on the CPU.

Targets are indices, so ``tgt`` must be bit-equal; ``diag`` and ``elems``
are float32 from the same float32 formulas summed in another order (XLA's
CPU dot against a torch matmul), held to 4 float32 ulps of each entry's
magnitude (:func:`_assert_f32_close`), and the port's ``diag`` to its own
host f64 diagonal at the same bound.  The ELL
product is held to the host f64 sparse matrix to 1e-5 (float32 sums of
C terms).
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_torch.convert import spin_hamiltonian_from_jax
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import skqd
from flow_guided_krylov_torch.ops.ell_spmv import ell_spmv

torch.set_num_threads(1)

TABLE_ULPS = 4
PRODUCT_TOL = 1e-5


def _assert_f32_close(got, want, err_msg=""):
    """|got - want| <= TABLE_ULPS * eps32 * max(1, |want|), entry by entry:
    a bound in float32 ulps of the magnitude, so that the summation order
    a host CPU's vector width picks cannot decide it."""
    want = np.asarray(want, np.float64)
    bound = TABLE_ULPS * np.finfo(np.float32).eps * np.maximum(1.0,
                                                               np.abs(want))
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= bound).all(), (
        f"{err_msg}: {int((err > bound).sum())} entries past "
        f"{TABLE_ULPS} ulps, worst {float((err / bound).max()):.3g}x")


def _seed_basis(h, n):
    """HF and its strongest connections (tests/test_restricted_skqd.py)."""
    hf = h.get_hf_state()[None, :]
    conn, el = h.connections_np(hf)
    order = np.argsort(-np.abs(el[0]))
    basis = np.concatenate([hf, conn[0][order[:n - 1]]], axis=0)
    _, first = np.unique(h.keys(basis), return_index=True)
    return basis[np.sort(first)]


def _heisenberg12():
    n = 12
    jh = jspin.HeisenbergHamiltonian(n, 1.0, 1.0, 1.0,
                                     h_z=np.array([0.1] + [0.0] * (n - 1)))
    neel = np.array([sum(1 << i for i in range(0, n, 2))], np.uint32)
    js = jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(), initial_state=neel)
    ps = skqd.SampleBasedKrylovDiagonalization(
        spin_hamiltonian_from_jax(jh, "cpu"), skqd.SKQDConfig(),
        initial_state=neel)
    return js, ps


def _lih_restricted():
    jh = jmol.create_lih_hamiltonian()
    ph = pmol.create_lih_hamiltonian("cpu")
    states = jskqd.build_restricted_subspace(
        jh, _seed_basis(jh, 20), 100, initial_state=jh.get_hf_state())
    cfg = dict(initial_state=jh.get_hf_state(), subspace_states=states)
    js = jskqd.FlowGuidedSKQD(jh, states[:5], jskqd.SKQDConfig(), **cfg)
    ps = skqd.FlowGuidedSKQD(ph, states[:5], skqd.SKQDConfig(), **cfg)
    return js, ps


@pytest.fixture(scope="module", params=["heisenberg12_sector",
                                        "lih_restricted"])
def pair(request):
    js, ps = (_heisenberg12() if request.param == "heisenberg12_sector"
              else _lih_restricted())
    np.testing.assert_array_equal(js.subspace, ps.subspace)
    return js, ps


def test_build_ell_device_matches_jax(pair):
    js, ps = pair
    jd, je, jt = (np.asarray(a) for a in js._build_ell_device(js.subspace))
    d, e, t = ps._build_ell_device(ps.subspace)
    assert (d.dtype, e.dtype, t.dtype) == (torch.float32, torch.float32,
                                           torch.int32)
    assert e.shape == t.shape == (ps.h.n_connections, ps.dim)
    assert e.is_contiguous() and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), jt)
    _assert_f32_close(d.numpy(), jd, "diag against JAX")
    _assert_f32_close(e.numpy(), je, "elems against JAX")
    _assert_f32_close(d.numpy(), ps.h.diagonal_np(ps.subspace),
                      "diag against the host f64 diagonal")


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_build_equals_one_chunk(pair, chunk):
    _, ps = pair
    whole = ps._build_ell_device(ps.subspace, chunk=ps.dim)
    parts = ps._build_ell_device(ps.subspace, chunk=chunk)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_ell_product_equals_host_sparse(pair):
    _, ps = pair
    diag, elems, tgt = ps._ell_structure()
    v = np.random.default_rng(0).normal(size=(2, ps.dim)).astype(np.float32)
    got = ell_spmv(diag, elems, tgt, torch.tensor(v)).numpy()
    want = (ps.h.to_sparse(ps.subspace) @ v.T.astype(np.float64)).T
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PRODUCT_TOL * np.abs(want).max())


def test_misses_are_zeroed(pair):
    """A connection that leaves the state set has element 0 and target 0;
    every hit points at the state whose key it carries."""
    _, ps = pair
    _, elems, tgt = ps._ell_structure()
    conn, el = ps.h.connections_np(ps.subspace)
    keys = ps.h.keys(conn.reshape(-1, conn.shape[-1])).reshape(el.shape)
    member = np.isin(keys, ps.h.keys(ps.subspace))
    assert not elems.numpy().T[~member].any()
    assert not tgt.numpy().T[~member].any()
    np.testing.assert_array_equal(
        ps.h.keys(ps.subspace)[tgt.numpy().T[member]], keys[member])


def test_spin_ell_evolution_no_longer_raises():
    """``evolution='ell'`` on a spin sector runs the device-built table
    and agrees with the f64 scipy propagator to 1e-5 (float32 Lanczos)."""
    _, ps = _heisenberg12()
    ps.config.evolution = "ell"
    psi = np.zeros(ps.dim, complex)
    psi[ps._index_of(ps.initial_state)[0]] = 1.0
    got = ps.evolve(psi)
    assert np.abs(got - ps._evolve_scipy(psi)).max() < 1e-5


def test_table_past_the_budget_raises(monkeypatch):
    _, ps = _heisenberg12()
    monkeypatch.setattr(ps, "_ell_fits_memory", lambda: False)
    with pytest.raises(skqd.EvolutionBudgetError):
        ps._ell_structure()
