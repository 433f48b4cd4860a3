"""Port parity: the host oracles the entry points need, each a copy of its
JAX original, held to it on the same inputs.

Bit for bit, or to 1e-12 where a floating-point path differs:
``PauliString.apply``, ``to_pauli_strings`` (H2, LiH), ``fci_state``
(energy; vector up to sign), ``ProjectedHamiltonianBuilder`` (TFIM-8 and
Heisenberg-8 over all 256 states, dense and sparse),
``postprocessing/utils.py``, the three host eigensolver routines (every
arm), ``ops/brute_force.py`` (and against the port's projected H on H2
and a 4-orbital LiH window), ``chem/ccsd.py`` (the molecules of
``tests/test_ccsd.py``; blocked triples equal to the full contraction)
and ``SystemScaler.create_pipeline_config`` over every tier and preset.
Inputs come from a numpy seed; the JAX package runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from flow_guided_krylov_tpu.chem import ccsd as jccsd
from flow_guided_krylov_tpu.chem import compute_molecular_integrals as jints
from flow_guided_krylov_tpu.hamiltonians import MOLECULE_FACTORIES as JMOL
from flow_guided_krylov_tpu.hamiltonians import base as jbase
from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.ops import brute_force as jbf
from flow_guided_krylov_tpu.postprocessing import eigensolver as jeig
from flow_guided_krylov_tpu.postprocessing import projected_hamiltonian as jph
from flow_guided_krylov_tpu.postprocessing import utils as jutils
from flow_guided_krylov_tpu.utils import system_scaler as jscaler
from flow_guided_krylov_torch.chem import (ccsd, compute_active_space_integrals,
                                           compute_molecular_integrals)
from flow_guided_krylov_torch.hamiltonians import (MOLECULE_FACTORIES,
                                                   HeisenbergHamiltonian,
                                                   MolecularHamiltonian,
                                                   PauliString,
                                                   TransverseFieldIsing,
                                                   create_synthetic_hamiltonian,
                                                   extract_coeffs_and_paulis)
from flow_guided_krylov_torch.ops import brute_force as bf
from flow_guided_krylov_torch.postprocessing import eigensolver as eig
from flow_guided_krylov_torch.postprocessing import projected_hamiltonian as ph
from flow_guided_krylov_torch.postprocessing import utils as putils
from flow_guided_krylov_torch.utils import system_scaler as scaler

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))


# ---------------------------------------------------------------------------
# Pauli words and the projected-H builder
# ---------------------------------------------------------------------------

def test_pauli_string_apply_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(1, 12))
        word = "".join(rng.choice(list("IXYZ"), n))
        coef = complex(rng.normal(), rng.normal())
        p, q = PauliString(word, coef), jbase.PauliString(word, coef)
        assert (p.x_mask, p.z_mask, p.n_y, p.is_diagonal) == \
            (q.x_mask, q.z_mask, q.n_y, q.is_diagonal)
        for state in rng.integers(0, 1 << n, 8):
            assert p.apply(int(state)) == q.apply(int(state))
    with pytest.raises(ValueError):
        PauliString("XQ")


@pytest.mark.parametrize("name", ["h2", "lih"])
def test_to_pauli_strings_matches_jax(name):
    words = MOLECULE_FACTORIES[name]("cpu").to_pauli_strings()
    ref = JMOL[name]().to_pauli_strings()
    assert [w.paulis for w in words] == [w.paulis for w in ref]
    np.testing.assert_allclose([w.coefficient for w in words],
                               [w.coefficient for w in ref], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", ["h2", "lih"])
def test_fci_state_matches_jax(name):
    e, vec, basis = MOLECULE_FACTORIES[name]("cpu").fci_state()
    je, jvec, jbasis = JMOL[name]().fci_state()
    assert abs(e - je) < TOL
    np.testing.assert_array_equal(basis, jbasis)
    sign = np.sign(vec @ jvec)
    np.testing.assert_allclose(sign * vec, jvec, rtol=0, atol=1e-10)


def _spins(model, n=8):
    if model == "tfim":
        return (TransverseFieldIsing(n, V=1.0, h=0.7, device="cpu"),
                jspin.TransverseFieldIsing(n, V=1.0, h=0.7))
    hz = np.zeros(n)
    hz[0] = 0.1
    return (HeisenbergHamiltonian(n, 1.0, 1.0, 0.8, h_x=np.full(n, 0.3),
                                  h_z=hz, device="cpu"),
            jspin.HeisenbergHamiltonian(n, 1.0, 1.0, 0.8,
                                        h_x=np.full(n, 0.3), h_z=hz))


@pytest.mark.parametrize("model", ["tfim", "heisenberg"])
def test_projected_builder_matches_jax_and_exact_dense(model):
    h, jh = _spins(model)
    coeffs, words = extract_coeffs_and_paulis(h)
    states = np.arange(256, dtype=np.uint64)
    b = ph.ProjectedHamiltonianBuilder.from_coeffs_and_words(coeffs, words)
    jb = jph.ProjectedHamiltonianBuilder.from_coeffs_and_words(coeffs, words)
    dense = b.build_dense(states)
    np.testing.assert_array_equal(dense, jb.build_dense(states))
    sparse, jsparse = b.build_sparse(states), jb.build_sparse(states)
    assert (sparse != jsparse).nnz == 0
    np.testing.assert_allclose(sparse.toarray(), dense, rtol=0, atol=TOL)
    # independent of the port's connection closures, and equal to them
    np.testing.assert_allclose(dense, h.exact_dense(), rtol=0, atol=TOL)
    # a subset basis and the non-hermitized path
    sub = np.random.default_rng(1).choice(256, 60, replace=False)
    cfg = ph.ProjectedHamiltonianConfig(hermitize=False)
    jcfg = jph.ProjectedHamiltonianConfig(hermitize=False)
    np.testing.assert_array_equal(
        ph.ProjectedHamiltonianBuilder(b.paulis, cfg).build_dense(sub),
        jph.ProjectedHamiltonianBuilder(jb.paulis, jcfg).build_dense(sub))


# ---------------------------------------------------------------------------
# postprocessing/utils.py
# ---------------------------------------------------------------------------

def test_measurement_utils_match_jax():
    rng = np.random.default_rng(2)
    counts = [{int(k): int(c) for k, c in zip(rng.integers(0, 64, 30),
                                                rng.integers(1, 50, 30))}
              for _ in range(3)]
    assert putils.merge_measurements(counts) == \
        jutils.merge_measurements(counts)
    merged = putils.merge_measurements(counts)
    for kw in ({}, {"min_probability": 0.02}, {"max_states": 7}):
        assert putils.filter_by_probability(merged, **kw) == \
            jutils.filter_by_probability(merged, **kw)
    for s in ("0101", "1", "0000", "1101001"):
        assert putils.bitstring_to_int(s) == jutils.bitstring_to_int(s)
        x = putils.bitstring_to_int(s)
        assert putils.int_to_bitstring(x, len(s)) == s
    c = rng.normal(size=300) * np.exp(-np.arange(300) / 20)
    assert putils.ground_state_sparsity(c) == jutils.ground_state_sparsity(c)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_basis_overlap_and_merge_bases(width):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 40, (50, width)).astype(np.uint32)
    b = np.concatenate([a[:20], rng.integers(0, 40, (30, width))
                        ]).astype(np.uint32)
    if width < 4:
        assert putils.basis_overlap(a, b) == jutils.basis_overlap(a, b)
        np.testing.assert_array_equal(putils.merge_bases(a, b),
                                      jutils.merge_bases(a, b))
        return
    # four-word rows: the keys of a 34-orbital determinant (KEY128)
    h = create_synthetic_hamiltonian(34, 2, 2, "cpu")
    assert h.pack_words == 4
    ta, tb = {tuple(r) for r in a}, {tuple(r) for r in b}
    assert putils.basis_overlap(a, b, keys_fn=h.keys) == {
        "n_a": len(ta), "n_b": len(tb), "n_common": len(ta & tb),
        "n_a_only": len(ta - tb), "n_b_only": len(tb - ta)}


# ---------------------------------------------------------------------------
# Host eigensolvers
# ---------------------------------------------------------------------------

def _sym(n, seed, density=None):
    """A symmetric matrix whose low spectrum is well separated (the
    iterative arms converge in a few restarts)."""
    rng = np.random.default_rng(seed)
    d = np.arange(n, dtype=float)
    d[:3] -= (3 * n, 2 * n, n)
    if density is None:
        a = 0.1 * rng.normal(size=(n, n))
        return 0.5 * (a + a.T) + np.diag(d)
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    return (a + a.T) * 0.05 + sp.diags(d)


@pytest.mark.parametrize("n,k", [(40, 1), (40, 3), (2100, 2)])
def test_generalized_eigenvalue_matches_jax(n, k):
    H = _sym(n, 4)
    for S in ((None, np.eye(n) + 0.001 * _sym(n, 5)) if n < 100
              else (None,)):
        got = eig.solve_generalized_eigenvalue(H, S, k=k)
        ref = jeig.solve_generalized_eigenvalue(H, S, k=k)
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-10)
        assert got[0].shape == (k,)
    reg = eig.solve_generalized_eigenvalue(H[:30, :30], k=1,
                                           regularization=0.5)
    np.testing.assert_array_equal(
        reg[0], jeig.solve_generalized_eigenvalue(H[:30, :30], k=1,
                                                  regularization=0.5)[0])


def test_regularize_overlap_matches_jax():
    rng = np.random.default_rng(6)
    v = rng.normal(size=(12, 4))
    S = v @ v.T                                   # rank 4: clamped
    np.testing.assert_array_equal(eig.regularize_overlap_matrix(S),
                                  jeig.regularize_overlap_matrix(S))
    assert np.linalg.eigvalsh(eig.regularize_overlap_matrix(S)).min() \
        > 1e-11


@pytest.mark.parametrize("n,k,sparse", [
    (100, 1, False),      # dense eigh
    (800, 1, False),      # Davidson
    (800, 2, False),      # eigsh (k > 1 in the Davidson range)
    (5200, 1, False),     # eigsh
    (300, 1, True),       # sparse input, dense
    (900, 2, True),       # sparse input, eigsh
])
def test_adaptive_eigensolver_arms_match_jax(n, k, sparse):
    H = _sym(n, 7, density=0.01 if sparse or n > 5000 else None)
    if n > 5000 and not sparse:
        H = H.toarray()
    vals, vecs = eig.adaptive_eigensolver(H, k=k)
    jvals, jvecs = jeig.adaptive_eigensolver(H, k=k)
    np.testing.assert_allclose(vals, jvals, rtol=0, atol=1e-9)
    assert vecs.shape == jvecs.shape == (n, k)
    if n < 1000:
        dense = H.toarray() if sp.issparse(H) else H
        np.testing.assert_allclose(vals[0], np.linalg.eigvalsh(dense)[0],
                                   rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# Brute-force Fock-space oracle
# ---------------------------------------------------------------------------

def _fock_index(basis, n):
    return basis[:, 0].astype(np.int64) | (basis[:, 1].astype(np.int64) << n)


@pytest.mark.parametrize("name", ["h2", "lih"])
def test_brute_force_matches_jax_and_projected_h(name):
    h = MOLECULE_FACTORIES[name]("cpu")
    if name == "lih":
        # a 4-orbital window (256 Fock states): the full 6-orbital space
        # has 4,096, too many for the Python loops
        h = MolecularHamiltonian(
            compute_active_space_integrals(h.integrals, n_frozen=1,
                                           n_active=4), "cpu")
    i = h.integrals
    H = bf.dense_hamiltonian_fock(i.h1e, i.h2e, i.nuclear_repulsion)
    np.testing.assert_array_equal(
        H, jbf.dense_hamiltonian_fock(i.h1e, i.h2e, i.nuclear_repulsion))
    basis = h.enumerate_basis()
    idx = _fock_index(basis, h.n_orbitals)
    np.testing.assert_allclose(H[np.ix_(idx, idx)],
                               h.matrix_elements(basis, basis), rtol=0,
                               atol=1e-10)
    assert bf.apply_annihilate(0b101, 1) is None
    assert bf.apply_create(0b101, 1) == (0b111, -1)


# ---------------------------------------------------------------------------
# CCSD(T)
# ---------------------------------------------------------------------------

def _ints(name):
    if name == "h2_631g":
        geom = [("H", (0, 0, 0)), ("H", (0, 0, 0.74))]
        return (compute_molecular_integrals(geom, basis="6-31g"),
                jints(geom, basis="6-31g"))
    return MOLECULE_FACTORIES[name]("cpu").integrals, JMOL[name]().integrals


@pytest.mark.parametrize("name", ["h2", "h2_631g", "lih", "h2o", "beh2"])
def test_ccsd_matches_jax(name):
    ints, jint = _ints(name)
    res = ccsd.run_ccsd(ints, do_triples=True)
    ref = jccsd.run_ccsd(jint, do_triples=True)
    assert res.converged and ref.converged
    assert res.n_iterations == ref.n_iterations
    for f in ("e_corr", "e_tot", "e_triples", "e_tot_t"):
        assert abs(getattr(res, f) - getattr(ref, f)) < TOL, f
    assert abs(ccsd.mp2_energy_closed_shell(ints)
               - jccsd.mp2_energy_closed_shell(jint)) < TOL
    e = res.e_tot + 1e-4
    got, want = (ccsd.ccsd_reference_dict(ints, e),
                 jccsd.ccsd_reference_dict(jint, e))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=TOL), k


@pytest.mark.parametrize("name", ["lih", "h2o"])
def test_blocked_triples_equal_full(name):
    ints, _ = _ints(name)
    h1, eri, occ = ccsd._spin_orbital_tensors(ints)
    f = h1 + np.einsum("piqi->pq", eri[:, occ][:, :, :, occ], optimize=True)
    o = np.asarray(occ, dtype=np.int64)
    v = np.array([p for p in range(h1.shape[0]) if p not in set(occ)],
                 dtype=np.int64)
    fd = np.diag(f)
    ix = np.ix_
    oovv, ovvv, ooov = (eri[ix(o, o, v, v)], eri[ix(o, v, v, v)],
                        eri[ix(o, o, o, v)])
    t1 = f[ix(o, v)] / (fd[o][:, None] - fd[v][None, :])
    t2 = oovv / (fd[o][:, None, None, None] + fd[o][None, :, None, None]
                 - fd[v][None, None, :, None] - fd[v][None, None, None, :])
    full = ccsd._perturbative_triples(t1, t2, oovv, ovvv, ooov, fd, o, v)
    blocked = ccsd._perturbative_triples_blocked(t1, t2, oovv, ovvv, ooov,
                                                 fd, o, v)
    assert full == pytest.approx(blocked, abs=1e-12, rel=1e-10)
    assert full == jccsd._perturbative_triples(t1, t2, oovv, ovvv, ooov, fd,
                                               o, v)


# ---------------------------------------------------------------------------
# SystemScaler
# ---------------------------------------------------------------------------

SIZES = [2, 50, 100, 101, 999, 1_000, 1_001, 9_999, 10_000, 10_001, 99_999,
         100_000, 100_001, 250_001, 4_008_004]


@pytest.mark.parametrize("preset", ["fast", "balanced", "accurate"])
def test_system_scaler_config_matches_jax(preset):
    tiers = set()
    for n in SIZES:
        s = scaler.SystemScaler(n, scaler.QualityPreset(preset))
        js = jscaler.SystemScaler(n, jscaler.QualityPreset(preset))
        tiers.add(s.tier.value)
        assert s.tier.value == js.tier.value
        assert s.scaled_parameters() == js.scaled_parameters()
        got = dataclasses.asdict(s.create_pipeline_config(verbose=False))
        assert got == dataclasses.asdict(
            js.create_pipeline_config(verbose=False))
        assert dataclasses.asdict(scaler.create_pipeline_config(
            n, scaler.QualityPreset(preset), seed=3)) == dict(got, seed=3,
                                                               verbose=True)
    assert tiers == {t.value for t in scaler.SystemTier}


def test_auto_scale_and_memory_parameters():
    h = MOLECULE_FACTORIES["lih"]("cpu")
    cfg = scaler.auto_scale_pipeline(h, scaler.QualityPreset.FAST)
    assert cfg == scaler.create_pipeline_config(225,
                                                scaler.QualityPreset.FAST)
    spin = TransverseFieldIsing(8, device="cpu")
    assert scaler.auto_scale_pipeline(spin) == \
        scaler.create_pipeline_config(256)
    mem = scaler.SystemScaler(225).memory_parameters(12, device="cpu")
    assert set(mem) == {"nqs_chunk_size", "connection_table_max_entries",
                        "dense_local_energy_max_dim", "statevector_sites_cap"}
    assert all(isinstance(v, int) and v > 0 for v in mem.values())
