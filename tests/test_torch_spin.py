"""Port parity: spin Hamiltonians, keys at one word per configuration, and
the circuit sampler, against the JAX package on the CPU.

Every port Hamiltonian here is rebuilt from the JAX instance by
``convert.spin_hamiltonian_from_jax``, so both packages compute from one
source.  Configurations and keys must be bit-identical; f64 matrix
elements agree to 1e-12 (the same host arithmetic in both packages).
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.hamiltonians.molecular import \
    create_lih_hamiltonian as jax_lih
from flow_guided_krylov_tpu.krylov import basis_sampler as jbs
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_torch.convert import spin_hamiltonian_from_jax
from flow_guided_krylov_torch.hamiltonians import spin
from flow_guided_krylov_torch.hamiltonians.molecular import \
    MolecularHamiltonian
from flow_guided_krylov_torch.krylov import basis_sampler as bs
from flow_guided_krylov_torch.krylov import skqd
from flow_guided_krylov_torch.ops import x_sweep as xs

torch.set_num_threads(1)

N = 8
JAX_SPINS = {
    "tfim_L1_periodic": lambda: jspin.TransverseFieldIsing(N, V=1.0, h=0.7),
    "tfim_L1_open": lambda: jspin.TransverseFieldIsing(N, V=0.8, h=1.1,
                                                       periodic=False),
    "tfim_L2_periodic": lambda: jspin.TransverseFieldIsing(N, V=0.5, h=1.3,
                                                           L=2),
    "tfim_L2_open": lambda: jspin.TransverseFieldIsing(N, V=1.2, h=0.4, L=2,
                                                       periodic=False),
    "heisenberg_hz": lambda: jspin.HeisenbergHamiltonian(
        N, 1.0, 1.0, 0.8, h_z=0.2 * np.arange(1, N + 1) / N),
    "heisenberg_hx": lambda: jspin.HeisenbergHamiltonian(
        N, 1.0, 1.0, 1.0, h_x=np.full(N, 0.3)),
}


@pytest.fixture(scope="module", params=sorted(JAX_SPINS))
def pair(request):
    jh = JAX_SPINS[request.param]()
    return jh, spin_hamiltonian_from_jax(jh, "cpu")


def _states():
    return np.arange(1 << N, dtype=np.uint32)[:, None]


def test_fields_and_keys_match_jax(pair):
    jh, h = pair
    assert type(h).__name__ == type(jh).__name__
    assert (h.n_sites, h.pack_words, h.n_connections) == (
        jh.n_sites, jh.pack_words, jh.n_connections)
    assert h.device == torch.device("cpu")
    assert getattr(h, "conserves_magnetization", None) == \
        getattr(jh, "conserves_magnetization", None)
    np.testing.assert_array_equal(h.keys(_states()), jh.keys(_states()))


def test_connections_and_diagonal_match_jax(pair):
    jh, h = pair
    conn, el = h.connections_np(_states())
    j_conn, j_el = jh.connections_np(_states())
    assert conn.dtype == np.uint32 and conn.shape == j_conn.shape
    np.testing.assert_array_equal(conn, j_conn)
    np.testing.assert_allclose(el, j_el, rtol=0, atol=1e-12)
    np.testing.assert_allclose(h.diagonal_np(_states()),
                               jh.diagonal_np(_states()), rtol=0, atol=1e-12)


def test_exact_dense_and_pauli_words_match_jax(pair):
    jh, h = pair
    np.testing.assert_allclose(h.exact_dense(), jh.exact_dense(), rtol=0,
                               atol=1e-12)
    assert spin.extract_coeffs_and_paulis(h) == \
        jspin.extract_coeffs_and_paulis(jh)
    coeffs, words = spin.extract_coeffs_and_paulis(h)
    assert [xs._pauli_masks(w) for w in words] == \
        [jbs._pauli_masks(w) for w in words]


@pytest.mark.parametrize("build,match", [
    (lambda: spin.HeisenbergHamiltonian(6, Jx=1.0, Jy=0.5, device="cpu"),
     "Jx != Jy"),
    (lambda: spin.HeisenbergHamiltonian(6, h_y=np.full(6, 0.1),
                                        device="cpu"), "h_y"),
    # two words a configuration from 32 sites: the full-2^n statevector
    # and spin SKQD stay unported (ROADMAP item 2 remainder)
    (lambda: spin.TransverseFieldIsing(32, device="cpu").full_diagonal_np(),
     "n <= 31"),
    (lambda: skqd.SampleBasedKrylovDiagonalization(
        spin.create_heisenberg_hamiltonian(40, device="cpu")),
     "item 2 remainder"),
], ids=["jx_ne_jy", "h_y", "tfim_32", "heisenberg_40"])
def test_unsupported_spin_models_raise(build, match):
    with pytest.raises(NotImplementedError, match=match):
        build()


def test_pack_helpers_match_jax():
    for n, x in ((5, 0b10110), (31, (1 << 31) - 1), (24, 0x5A5A5A)):
        row = spin.pack_spin_state(x, n)
        np.testing.assert_array_equal(row, jspin.pack_spin_state(x, n))
        assert spin.spin_state_int(row) == jspin.spin_state_int(row) == x
    np.testing.assert_array_equal(skqd._sector_states(10, 4),
                                  jskqd._sector_states(10, 4))


def test_keys_round_trip_one_word():
    """W = 1: the key is the word, 1-D input is a batch of words, and
    ``unkey`` inverts ``keys`` as in the JAX base."""
    jh = jspin.TransverseFieldIsing(31, h=0.5)
    h = spin_hamiltonian_from_jax(jh, "cpu")
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1 << 31, size=(64, 1), dtype=np.uint64
                        ).astype(np.uint32)
    k = h.keys(rows)
    assert k.dtype == np.uint64
    np.testing.assert_array_equal(k, jh.keys(rows))
    np.testing.assert_array_equal(h.keys(rows[:, 0]), jh.keys(rows[:, 0]))
    np.testing.assert_array_equal(h.unkey(k), rows)
    np.testing.assert_array_equal(h.unkey(k), jh.unkey(k))


def test_keys_unchanged_at_two_words():
    """W = 2 (molecular): keys stay (alpha << 32) | beta, bit for bit."""
    jh = jax_lih()
    h = MolecularHamiltonian(jh.integrals, device="cpu")
    dets = jh.enumerate_basis()
    dets[0] = [0xFFFFFFFF, 0x80000001]          # the top bits of both words
    k = h.keys(dets)
    np.testing.assert_array_equal(k, jh.keys(dets))
    np.testing.assert_array_equal(
        k, (dets[:, 0].astype(np.uint64) << np.uint64(32)) | dets[:, 1])
    np.testing.assert_array_equal(h.unkey(k), dets)


def test_circuit_sampler_matches_jax():
    """The first-order circuit sampler evolves like the JAX one (float32,
    16 rotations per step); its counts come from the port's own
    generator, so only their total and support are checked."""
    jh = jspin.HeisenbergHamiltonian(6, 1.0, 1.0, 0.7, h_x=np.full(6, 0.4))
    h = spin_hamiltonian_from_jax(jh, "cpu")
    cfg = dict(shots=3000, num_trotter_steps=4, time_step=0.3, seed=2)
    js = jbs.create_circuit_sampler(jh, jbs.CircuitSamplerConfig(**cfg))
    ps = bs.create_circuit_sampler(h, bs.CircuitSamplerConfig(**cfg))
    want = js.evolve_statevector(0.3)
    got = ps.evolve_statevector(0.3)
    assert np.abs(got - want).max() < 2e-6
    counts = ps.sample()
    assert sum(counts.values()) == 3000
    assert all(0 <= k < 64 and abs(got[k]) > 0 for k in counts)
    bases = ps.sample_krylov_bases(3)
    assert list(bases[0]) == [ps._initial_state()]


def test_spin_subspace_routes():
    """Small spin systems evolve in an enumerated subspace: the dense
    and the ELL propagator (over the device-built sector table) agree
    with scipy to 1e-5 (float32 Lanczos)."""
    jh = jspin.HeisenbergHamiltonian(10, 1.0, 1.0, 1.0,
                                     h_z=np.r_[0.1, np.zeros(9)])
    h = spin_hamiltonian_from_jax(jh, "cpu")
    outs = {}
    for mode in ("dense", "scipy", "ell"):
        s = skqd.SampleBasedKrylovDiagonalization(
            h, skqd.SKQDConfig(evolution=mode))
        assert not s.use_trotter and s.dim == 252 and s._sector_n_up == 5
        psi0 = np.zeros(s.dim, complex)
        psi0[s._index_of(s.initial_state)[0]] = 1.0
        outs[mode] = s.evolve(psi0)
    assert np.abs(outs["dense"] - outs["scipy"]).max() < 1e-5
    assert np.abs(outs["ell"] - outs["scipy"]).max() < 1e-5
    js = jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(evolution="scipy"))
    np.testing.assert_array_equal(s.subspace, js.subspace)
    np.testing.assert_array_equal(s.initial_state, js.initial_state)


def test_spin_skqd_subspace_run_matches_jax_energy():
    """Pure SKQD on TFIM-8 through the enumerated-space dense propagator:
    each package's run is variational and under 1.6 mHa, and on the same
    bases both eigensolves agree."""
    jh = jspin.TransverseFieldIsing(8, V=1.0, h=0.5)
    h = spin_hamiltonian_from_jax(jh, "cpu")
    e_exact = np.linalg.eigh(h.exact_dense())[0][0]
    cfg = dict(max_krylov_dim=10, shots_per_krylov=20000, time_step=0.1,
               seed=1)
    init = np.array([0], np.uint32)
    ps = skqd.SampleBasedKrylovDiagonalization(
        h, skqd.SKQDConfig(**cfg), initial_state=init)
    out = ps.run()
    assert not ps.use_trotter
    err = 1000 * (out["final_energy"] - e_exact)
    assert -1e-6 <= err < 1.6
    js = jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(**cfg), initial_state=init)
    for b in out["bases"][::3]:
        assert abs(ps.compute_ground_state_energy(b)
                   - js.compute_ground_state_energy(b)) < 1e-9
