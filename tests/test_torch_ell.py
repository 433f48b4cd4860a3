"""Port parity: ELL SpMV, the Lanczos propagators, sampling and the SKQD
eigensolve, against the JAX package on the CPU (LiH/STO-3G, 225 dets).

The CUDA kernel itself runs only on a card: see ``test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow_guided_krylov_tpu.hamiltonians.molecular import \
    create_lih_hamiltonian as jax_lih
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_tpu.ops.pallas_spmv import \
    ell_spmv_reference as jax_ell_reference
from flow_guided_krylov_torch.convert import ell_from_jax
from flow_guided_krylov_torch.hamiltonians.molecular import \
    MolecularHamiltonian
from flow_guided_krylov_torch.krylov import skqd
from flow_guided_krylov_torch.ops import ell_spmv as ell
from flow_guided_krylov_torch.utils.connection_table import \
    build_connection_table

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lih():
    """(JAX Hamiltonian, JAX SKQD, port Hamiltonian, JAX ELL as numpy)."""
    jh = jax_lih()
    js = jskqd.SampleBasedKrylovDiagonalization(jh, jskqd.SKQDConfig())
    jell = tuple(np.asarray(a) for a in js._ell_structure())
    return jh, js, MolecularHamiltonian(jh.integrals, device="cpu"), jell


def _psi(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=n) + 1j * rng.normal(size=n)
    return psi / np.linalg.norm(psi)


def test_connection_table_matches_jax(lih):
    jh, js, h, (jdiag, jel_t, jtgt_t) = lih
    t = build_connection_table(h)
    np.testing.assert_array_equal(t.target_idx.numpy().T, jtgt_t)
    np.testing.assert_allclose(t.elems.numpy().T, jel_t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.diag.numpy(), jdiag, rtol=0, atol=1e-4)
    # lookup finds every enumerated determinant at its own index
    from flow_guided_krylov_torch.ops.bits import to_device
    basis = to_device(t.basis_packed, "cpu")
    np.testing.assert_array_equal(t.lookup(basis).numpy(),
                                  np.arange(t.n_configs))


def test_ell_reference_matches_jax(lih):
    _, _, _, jell = lih
    diag, el_t, tgt_t = ell_from_jax(*jell, device="cpu")
    assert (diag.dtype, el_t.dtype, tgt_t.dtype) == (
        torch.float32, torch.float32, torch.int32)
    rng = np.random.default_rng(0)
    psi = rng.normal(size=(2, diag.shape[0])).astype(np.float32)
    want = np.stack([np.asarray(jax_ell_reference(*map(jnp.asarray, jell),
                                                  jnp.asarray(p)))
                     for p in psi])
    got2 = ell.ell_spmv(diag, el_t, tgt_t, torch.as_tensor(psi))
    np.testing.assert_allclose(got2.numpy(), want, rtol=1e-5, atol=1e-5)
    # the (2, N) stack equals two (N,) calls, bit for bit
    for b in range(2):
        got1 = ell.ell_spmv(diag, el_t, tgt_t, torch.as_tensor(psi[b]))
        np.testing.assert_array_equal(got2[b].numpy(), got1.numpy())


def test_cuda_wrapper_refuses_cpu_tensors(lih):
    diag, el_t, tgt_t = ell_from_jax(*lih[3], device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ell.ell_spmv_cuda(diag, el_t, tgt_t, torch.zeros_like(diag))
    assert ell.ell_spmv_cuda.launches == 0


def test_lanczos_expm_ell_matches_jax(lih):
    _, _, _, jell = lih
    n = jell[0].shape[0]
    psi = _psi(n, 1)
    re, im = np.real(psi).astype(np.float32), np.imag(psi).astype(np.float32)
    jr, ji = jskqd.lanczos_expm_ell(*map(jnp.asarray, jell), jnp.asarray(re),
                                    jnp.asarray(im), jnp.float32(0.1), 30)
    pr, pi = skqd.lanczos_expm_ell(*ell_from_jax(*jell, device="cpu"),
                                   torch.as_tensor(re), torch.as_tensor(im),
                                   0.1, 30)
    assert np.abs(pr.numpy() - np.asarray(jr)).max() < 1e-5
    assert np.abs(pi.numpy() - np.asarray(ji)).max() < 1e-5


def test_evolution_modes_agree(lih):
    h = lih[2]
    outs = {}
    for mode in ("scipy", "dense", "ell"):
        s = skqd.SampleBasedKrylovDiagonalization(
            h, skqd.SKQDConfig(evolution=mode, seed=2))
        psi0 = np.zeros(s.dim, complex)
        psi0[s._index_of(h.get_hf_state())[0]] = 1.0
        outs[mode] = s.evolve(psi0)
    assert np.abs(outs["dense"] - outs["scipy"]).max() < 1e-5
    assert np.abs(outs["ell"] - outs["scipy"]).max() < 1e-5
    # the port's f64 propagator is the JAX package's
    js = jskqd.SampleBasedKrylovDiagonalization(
        lih[0], jskqd.SKQDConfig(evolution="scipy"))
    psi0 = np.zeros(js.dim, complex)
    psi0[js._index_of(lih[0].get_hf_state())[0]] = 1.0
    np.testing.assert_allclose(outs["scipy"], js.evolve(psi0), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_evolution_over_budget_raises(lih, monkeypatch, device):
    """When neither device propagator fits, ``auto`` raises instead of
    moving the work to the host.  The budgets are forced, so the routing
    is decided before any tensor reaches ``device``."""
    s = skqd.SampleBasedKrylovDiagonalization(lih[2], skqd.SKQDConfig())
    s.device = torch.device(device)
    monkeypatch.setattr(s, "_dense_evolution_cap", lambda: 0)
    monkeypatch.setattr(s, "_ell_fits_memory", lambda: False)
    monkeypatch.setattr(s, "_evolve_scipy", None)
    psi0 = np.zeros(s.dim, complex)
    psi0[0] = 1.0
    with pytest.raises(skqd.EvolutionBudgetError, match="evolution='scipy'"):
        s.evolve(psi0)


def test_inverse_cdf_sampler_matches_jax():
    """Fed JAX's uniforms for one key, the port draws the same indices.
    The probabilities are small integers, so both cumsums are exact in
    float32 whatever their summation order; the zeros check the
    side="right" rule."""
    rng = np.random.default_rng(3)
    prob = rng.integers(0, 6, size=500).astype(np.float32)
    prob[[0, 1, 250, 499]] = 0.0
    key = jax.random.PRNGKey(11)
    shots = 4000
    want = np.asarray(jskqd._sample_idx_cdf(key, jnp.asarray(prob), shots))
    u = np.asarray(jax.random.uniform(key, (shots,)))
    got = skqd._sample_idx_cdf(torch.tensor(prob), torch.tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert prob[got.numpy()].min() > 0


def test_ground_state_energy_on_jax_bases(lih):
    jh, _, h, _ = lih
    cfg = dict(max_krylov_dim=3, shots_per_krylov=300, seed=4)
    js = jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(evolution="dense", **cfg))
    bases = js.build_cumulative_basis(js.generate_krylov_samples())
    ps = skqd.SampleBasedKrylovDiagonalization(
        h, skqd.SKQDConfig(evolution="dense", **cfg))
    for b in bases:
        assert abs(ps.compute_ground_state_energy(b)
                   - js.compute_ground_state_energy(b)) < 1e-8

