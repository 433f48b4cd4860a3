"""Port parity: the spin Hamiltonians' device closures and the full-space
statevector products, against the JAX package on the CPU.

``diagonal_device`` / ``connections_device`` take int64 words and return
float32 elements; the JAX closures (``_spin_device_ops``) take uint32
words.  Configurations must be bit-identical.  Elements are products of
exactly representable couplings, so they agree to 1e-6; diagonals are
float32 sums of up to 2n terms, held to 1e-6 against JAX (the same terms,
perhaps in another order) and against the f64 host mirrors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_torch.convert import spin_hamiltonian_from_jax
from flow_guided_krylov_torch.ops.bits import to_device, to_host

torch.set_num_threads(1)

N = 10
JAX_SPINS = {
    "tfim10": lambda: jspin.TransverseFieldIsing(N, V=1.0, h=0.7),
    "tfim10_L2_open": lambda: jspin.TransverseFieldIsing(
        N, V=0.5, h=1.3, L=2, periodic=False),
    "heisenberg10": lambda: jspin.HeisenbergHamiltonian(
        N, 1.0, 1.0, 0.8, h_z=0.2 * np.arange(1, N + 1) / N),
    "heisenberg10_periodic": lambda: jspin.HeisenbergHamiltonian(
        N, 1.0, 1.0, 1.0, periodic=True),
    "heisenberg10_hx": lambda: jspin.HeisenbergHamiltonian(
        N, 1.0, 1.0, 1.0, h_x=np.full(N, 0.3), h_z=np.full(N, 0.1)),
}
ELEM_TOL = 1e-6
DIAG_TOL = 1e-6


@pytest.fixture(scope="module", params=sorted(JAX_SPINS))
def pair(request):
    jh = JAX_SPINS[request.param]()
    return jh, spin_hamiltonian_from_jax(jh, "cpu")


def _states(seed=3, rows=257):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << N, rows).astype(np.uint32)[:, None]


def test_diagonal_device_matches_jax_and_host(pair):
    jh, h = pair
    states = _states()
    got = h.diagonal_device(to_device(states, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (len(states),)
    want = np.asarray(jspin._spin_device_ops(jh)[0](jnp.asarray(states)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DIAG_TOL)
    np.testing.assert_allclose(got.numpy(), h.diagonal_np(states), rtol=0,
                               atol=DIAG_TOL)


def test_connections_device_match_jax_and_host(pair):
    jh, h = pair
    states = _states(seed=4)
    conn, elems = h.connections_device(to_device(states, "cpu"))
    assert conn.dtype == torch.int64 and elems.dtype == torch.float32
    assert conn.shape == (len(states), h.n_connections, 1)
    jconn, jelems = jspin._spin_device_ops(jh)[1](jnp.asarray(states))
    np.testing.assert_array_equal(to_host(conn), np.asarray(jconn))
    np.testing.assert_allclose(elems.numpy(), np.asarray(jelems), rtol=0,
                               atol=ELEM_TOL)
    hconn, helems = h.connections_np(states)
    np.testing.assert_array_equal(to_host(conn), hconn)
    np.testing.assert_allclose(elems.numpy(), helems, rtol=0, atol=ELEM_TOL)


def test_device_keys_order_like_host_keys(pair):
    _, h = pair
    states = _states(seed=5)
    dev = h.keys_device(to_device(states, "cpu"))
    np.testing.assert_array_equal(h.keys_to_host(dev), h.keys(states))
    np.testing.assert_array_equal(np.argsort(dev.numpy(), kind="stable"),
                                  np.argsort(h.keys(states), kind="stable"))


M = 8
STATEVECTOR_SPINS = {
    "tfim8": lambda: jspin.TransverseFieldIsing(M, V=1.0, h=1.0),
    "tfim7_L2": lambda: jspin.TransverseFieldIsing(7, V=0.5, h=1.3, L=2),
    "heisenberg8_hx_hz": lambda: jspin.HeisenbergHamiltonian(
        M, 1.0, 1.0, 0.8, h_x=0.3 * np.ones(M), h_z=0.1 * np.ones(M)),
    "heisenberg7_periodic": lambda: jspin.HeisenbergHamiltonian(
        7, 1.0, 1.0, 1.0, periodic=True),
}


@pytest.mark.parametrize("name", sorted(STATEVECTOR_SPINS))
def test_apply_statevector_np_equals_dense(name):
    """Host f64 slab flips against the dense matrix: 1e-12 (f64 sums of
    at most 2n terms of size ~1)."""
    h = spin_hamiltonian_from_jax(STATEVECTOR_SPINS[name](), "cpu")
    dense = h.exact_dense()
    v = np.random.default_rng(6).normal(size=dense.shape[0])
    np.testing.assert_allclose(h.apply_statevector_np(v), dense @ v,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(h.full_diagonal_np(), np.diag(dense),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(STATEVECTOR_SPINS))
def test_apply_statevector_equals_dense_and_jax(name):
    """Device float32 slab flips against the dense matrix (1e-5: f32 sums
    of up to 2n terms of size ~3) and the JAX twin (the same terms)."""
    from flow_guided_krylov_torch.postprocessing.eigensolver import \
        full_diagonal_device
    jh = STATEVECTOR_SPINS[name]()
    h = spin_hamiltonian_from_jax(jh, "cpu")
    dense = h.exact_dense()
    v = np.random.default_rng(7).normal(size=dense.shape[0]).astype(
        np.float32)
    diag = full_diagonal_device(h)
    np.testing.assert_allclose(diag.numpy(), np.diag(dense), rtol=0,
                               atol=1e-6)
    got = h.apply_statevector(torch.tensor(v), diag).numpy()
    np.testing.assert_allclose(got, dense @ v, rtol=0, atol=1e-5)
    want = np.asarray(jh.apply_statevector_jax(jnp.asarray(v),
                                               jnp.asarray(diag.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_two_words_still_raise():
    """32 sites take two words a configuration; the table-free full-2^n
    product holds one word a state and refuses them by name."""
    from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
    h = TransverseFieldIsing(32, device="cpu")
    assert h.pack_words == 2
    with pytest.raises(NotImplementedError, match="n <= 31"):
        h.apply_statevector(torch.zeros(4), torch.zeros(4))
