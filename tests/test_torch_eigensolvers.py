"""Port parity: the device Lanczos eigensolvers, the full-space route and
the subspace oracle, against dense ``eigh`` and the JAX package on the
CPU.

Device energies are float32 Lanczos values, held to 1e-5 Ha (|E| ~ 10:
a few float32 ulps of the Rayleigh quotient); host-refined energies are
f64 ``eigsh`` values at tol 1e-9, held to 1e-8 Ha.  One m = 20 Lanczos
run from one start vector is held to the JAX ``_lanczos_tridiag`` to 1e-4
in its alphas and betas (float32 recurrences of 20 steps in another
summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.postprocessing import eigensolver as jeig
from flow_guided_krylov_torch.convert import spin_hamiltonian_from_jax
from flow_guided_krylov_torch.hamiltonians import (HeisenbergHamiltonian,
                                                   create_lih_hamiltonian)
from flow_guided_krylov_torch.krylov import (SampleBasedKrylovDiagonalization,
                                             SKQDConfig)
from flow_guided_krylov_torch.postprocessing import eigensolver as eig
from flow_guided_krylov_torch.utils.memory import MemoryBudget

torch.set_num_threads(1)

DEVICE_TOL = 1e-5
REFINED_TOL = 1e-8
N = 10
JAX_SPINS = {
    "tfim10": lambda: jspin.TransverseFieldIsing(N, V=1.0, h=1.0),
    "heisenberg_hx10": lambda: jspin.HeisenbergHamiltonian(
        N, 1.0, 1.0, 0.8, h_x=0.3 * np.ones(N), h_z=0.1 * np.ones(N)),
}


@pytest.fixture(scope="module", params=sorted(JAX_SPINS))
def spin(request):
    jh = JAX_SPINS[request.param]()
    h = spin_hamiltonian_from_jax(jh, "cpu")
    dense = h.exact_dense()
    return jh, h, dense, float(np.linalg.eigvalsh(dense)[0])


def test_fullspace_tables_match_jax_and_dense(spin):
    jh, h, dense, _ = spin
    d, e, t = eig._build_fullspace_ell_device(h)
    jd, je, jt = (np.asarray(a) for a in jeig._build_fullspace_ell_device(jh))
    assert (e.dtype, t.dtype) == (torch.float32, torch.int32)
    assert e.is_contiguous() and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_allclose(e.numpy(), je, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-6)
    rebuilt = np.diag(d.numpy().astype(np.float64))
    cols = np.arange(1 << N)
    for c in range(e.shape[0]):
        np.add.at(rebuilt, (t.numpy()[c], cols), e.numpy()[c])
    np.testing.assert_allclose(rebuilt, dense, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        eig.full_diagonal_device(h).numpy(),
        np.asarray(jeig.full_diagonal_device(jh)), rtol=0, atol=1e-6)


def test_lanczos_ground_state_dense(spin):
    _, _, dense, exact = spin
    e, v = eig.lanczos_ground_state(torch.tensor(dense, dtype=torch.float32),
                                    m=80)
    assert abs(e - exact) < DEVICE_TOL
    assert abs(float(v.double() @ torch.tensor(dense) @ v.double())
               - exact) < DEVICE_TOL
    assert abs(float(torch.linalg.norm(v)) - 1.0) < 1e-5


@pytest.mark.parametrize("m,restarts", [(80, 1), (12, 12)])
def test_lanczos_ground_state_ell(spin, m, restarts):
    """A deep block, and a shallow one that recovers its depth by
    restarts."""
    _, h, _, exact = spin
    ell = eig._build_fullspace_ell_device(h)
    e, v = eig.lanczos_ground_state_ell(*ell, m=m, restarts=restarts)
    assert abs(e - exact) < DEVICE_TOL
    assert v.shape == (1 << N,) and v.dtype == torch.float32


def test_restarts_lower_the_energy(spin):
    _, h, _, exact = spin
    ell = eig._build_fullspace_ell_device(h)
    e1, _ = eig.lanczos_ground_state_ell(*ell, m=8, restarts=1)
    e4, _ = eig.lanczos_ground_state_ell(*ell, m=8, restarts=4)
    assert exact - DEVICE_TOL < e4 < e1


def test_lanczos_tridiagonal_matches_jax(spin):
    _, _, dense, _ = spin
    v0 = np.random.default_rng(2).normal(size=dense.shape[0]).astype(
        np.float32)
    h32 = dense.astype(np.float32)
    V, a, b = eig._lanczos_tridiag(torch.tensor(h32), torch.tensor(v0), 20)
    jV, ja, jb = jeig._lanczos_tridiag(jnp.asarray(h32), jnp.asarray(v0), 20)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(V.numpy()[:5], np.asarray(jV)[:5], rtol=0,
                               atol=1e-4)
    gram = (V @ V.T).numpy()
    np.testing.assert_allclose(gram, np.eye(20), rtol=0, atol=1e-5)


# device memory sizes under which the 2^10 spaces of these tests take each
# route: the tables fit 4 GiB; under 1 MiB only the table-free flips do
ROUTE_MEMORY = {"ell-fused": 4 << 30, "flip-stepped": 1 << 20}


@pytest.mark.parametrize("route", list(ROUTE_MEMORY))
def test_exact_fullspace_ground_state(spin, route, tmp_path, monkeypatch):
    from flow_guided_krylov_torch.utils import memory
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    monkeypatch.setattr(memory, "device_memory_bytes",
                        lambda device: ROUTE_MEMORY[route])
    _, h, _, exact = spin
    dev = eig.exact_fullspace_ground_state(h, refine_host=False,
                                           verbose=False)
    assert dev["route"] == route and dev["energy"] == dev["e_device"]
    assert abs(dev["energy"] - exact) < DEVICE_TOL
    assert not list(tmp_path.iterdir())       # device-only: nothing cached
    out = eig.exact_fullspace_ground_state(h, verbose=False)
    assert out["route"] == route
    assert abs(out["energy"] - exact) < REFINED_TOL
    assert abs(out["e_rayleigh_f32vec"] - exact) < DEVICE_TOL
    assert not out["cached"] and out["refine_matvecs"] > 0
    # the cache round trip
    again = eig.exact_fullspace_ground_state(h, verbose=False)
    assert again["cached"] and again["energy"] == out["energy"]
    assert eig._fullspace_cache_path(h).exists()
    fresh = eig.exact_fullspace_ground_state(h, verbose=False,
                                             use_cache=False)
    assert not fresh["cached"]


def test_fullspace_route_follows_memory(spin, monkeypatch):
    """Memory alone picks the route: tables when they fit, the
    table-free flips when only those fit, an error when neither does;
    the caller cannot name one."""
    import inspect
    from flow_guided_krylov_torch.utils import memory
    _, h, _, exact = spin
    for route, total in ROUTE_MEMORY.items():
        monkeypatch.setattr(memory, "device_memory_bytes",
                            lambda device, total=total: total)
        out = eig.exact_fullspace_ground_state(h, refine_host=False,
                                               verbose=False)
        assert out["route"] == route
        assert abs(out["energy"] - exact) < DEVICE_TOL
    monkeypatch.setattr(memory, "device_memory_bytes", lambda device: 1024)
    with pytest.raises(MemoryError):
        eig.exact_fullspace_ground_state(h, refine_host=False, verbose=False)
    assert "route" not in inspect.signature(
        eig.exact_fullspace_ground_state).parameters


def test_fullspace_cache_path_is_the_jax_package_s(spin, tmp_path,
                                                   monkeypatch):
    """The JAX package's hash and directory, under the port's own name, so
    neither package reads the other's oracle."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    jh, h, _, _ = spin
    path, jpath = eig._fullspace_cache_path(h), jeig._fullspace_cache_path(jh)
    assert path.parent == jpath.parent == tmp_path
    assert path.name == "torch_" + jpath.name


# ---------------------------------------------------------------------------
# The subspace oracle (the cases of tests/test_spin.py:239-272)
# ---------------------------------------------------------------------------

def _sector_skqd(n, jz=1.0):
    h = HeisenbergHamiltonian(n, 1.0, 1.0, jz,
                              h_z=np.array([0.1] + [0.0] * (n - 1)),
                              device="cpu")
    neel = sum(1 << i for i in range(0, n, 2))
    return SampleBasedKrylovDiagonalization(
        h, SKQDConfig(), initial_state=np.array([neel], np.uint32))


def test_exact_subspace_energy_matches_direct(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    s = _sector_skqd(10)
    assert s.dim == 252                          # C(10, 5) sector
    direct = float(s.h.exact_ground_state(s.subspace, k=1)[0][0])
    assert abs(s.exact_subspace_energy(refine_host=False) - direct) < 1e-3
    assert not list(tmp_path.iterdir())
    assert abs(s.exact_subspace_energy() - direct) < REFINED_TOL


def test_exact_subspace_energy_disk_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    from flow_guided_krylov_tpu.krylov import skqd as jskqd
    s = _sector_skqd(8)
    e1 = s.exact_subspace_energy()
    path = s._oracle_cache_path()
    assert path.exists()
    assert s.exact_subspace_energy() == e1       # cache hit round-trips
    assert _sector_skqd(8, jz=0.5)._oracle_cache_path() != path
    # the JAX package's hash and directory for the same Hamiltonian and
    # sector, under the port's own name
    jh = jspin.HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                                     h_z=np.array([0.1] + [0.0] * 7))
    js = jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(), initial_state=s.initial_state)
    jpath = js._oracle_cache_path()
    assert path.parent == jpath.parent and path.name == "torch_" + jpath.name


def test_exact_subspace_energy_raises_on_device_failure(tmp_path,
                                                        monkeypatch):
    """No host route around a device failure, refined or not."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    s = _sector_skqd(8)

    def broken():
        raise RuntimeError("device lost")

    monkeypatch.setattr(s, "_ell_structure", broken)
    for refine in (True, False):
        with pytest.raises(RuntimeError, match="device lost"):
            s.exact_subspace_energy(refine_host=refine)


def test_molecular_oracle_equals_fci(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    h = create_lih_hamiltonian("cpu")
    s = SampleBasedKrylovDiagonalization(h, SKQDConfig())
    assert abs(s.exact_subspace_energy() - h.fci_energy()) < REFINED_TOL


def test_seeded_eigsh_for_large_sampled_bases(monkeypatch):
    """Above the row threshold the projected eigensolve of a spin basis
    starts from a device ELL Lanczos vector: one table build, and the
    unseeded energy to 1e-8 (both are f64 eigsh values)."""
    s = _sector_skqd(14)
    basis = s.subspace                           # C(14, 7) = 3432 > 2048
    unseeded = s.compute_ground_state_energy(basis)
    calls = []
    build = s._build_ell_device
    monkeypatch.setattr(s, "_build_ell_device",
                        lambda b: calls.append(len(b)) or build(b))
    s.compute_ground_state_energy(basis[:2100])
    assert calls == []                           # below the threshold
    monkeypatch.setattr(type(s), "SEEDED_EIGSH_MIN_ROWS", 3000)
    e, v = s.compute_ground_state_energy(basis, return_vector=True)
    assert calls == [3432]
    assert abs(e - unseeded) < REFINED_TOL
    assert v.shape == (3432,) and abs(v @ v - 1.0) < 1e-10


def test_compute_ground_state_energy_return_vector():
    s = _sector_skqd(10)
    e, v = s.compute_ground_state_energy(s.subspace, return_vector=True)
    assert e == s.compute_ground_state_energy(s.subspace)
    H = s.h.matrix_elements(s.subspace, s.subspace)
    assert abs(v @ H @ v - e) < 1e-7 and abs(v @ v - 1.0) < 1e-12


# ---------------------------------------------------------------------------
# Memory sizing
# ---------------------------------------------------------------------------

def test_lanczos_ell_m_is_monotone():
    budget = MemoryBudget(80 << 30)
    ms = [budget.lanczos_ell_m(n, 24) for n in
          (1 << 20, 1 << 24, 1 << 26, 1 << 27, 1 << 28)]
    assert ms == sorted(ms, reverse=True) and ms[0] == 120 and ms[-1] >= 2
    cs = [budget.lanczos_ell_m(1 << 26, c) for c in (4, 16, 26, 40)]
    assert cs == sorted(cs, reverse=True) and cs[0] > cs[-1]
    totals = [MemoryBudget(g << 30).lanczos_ell_m(1 << 26, 26)
              for g in (16, 40, 80, 141)]
    assert totals == sorted(totals) and totals[0] < totals[-1]
    assert budget.lanczos_ell_m(1 << 20, 20, m_max=40) == 40
    # the Heisenberg-24 sector at C = 23 takes the full depth on 80 GB
    assert budget.lanczos_ell_m(2_704_156, 23) == 120


def test_build_chunk_rows_and_sites_cap():
    budget = MemoryBudget(80 << 30)
    assert budget.build_chunk_rows(23) == 1 << 19
    rows = budget.build_chunk_rows(2835)
    assert 64 <= rows < 1 << 19
    assert rows * 2835 * 96 <= 0.10 * (80 << 30)
    assert MemoryBudget(1 << 20).build_chunk_rows(2835) == 64
    assert budget.statevector_sites_cap() == 28
    assert MemoryBudget(1 << 30).statevector_sites_cap() == 24
    assert MemoryBudget(1 << 10).statevector_sites_cap() == 16
