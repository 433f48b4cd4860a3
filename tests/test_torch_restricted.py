"""Port parity: restricted-subspace SKQD (stage 4 beyond full-space
enumeration), the cases of ``tests/test_restricted_skqd.py`` on the port,
with the JAX package's own subspaces and rankings beside them.

The subspace builder and the PT2 ranking are host f64 NumPy in both
packages over bit-equal integrals, so states and keys must be equal and
scores agree to 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import residual_expansion as pre
from flow_guided_krylov_torch.krylov import skqd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lih():
    return jmol.create_lih_hamiltonian(), pmol.create_lih_hamiltonian("cpu")


def _seed_basis(h, n=24):
    """HF + its strongest connections as a stand-in stage-3 basis."""
    hf = h.get_hf_state()[None, :]
    conn, el = h.connections_np(hf)
    order = np.argsort(-np.abs(el[0]))
    basis = np.concatenate([hf, conn[0][order[:n - 1]]], axis=0)
    _, first = np.unique(h.keys(basis), return_index=True)
    return basis[np.sort(first)]


def test_build_restricted_subspace_invariants(lih):
    jh, h = lih
    basis = _seed_basis(h, 24)
    hf = h.get_hf_state()[None, :]
    cap = 80
    states = skqd.build_restricted_subspace(h, basis, cap, initial_state=hf)
    np.testing.assert_array_equal(
        states, jskqd.build_restricted_subspace(jh, basis, cap,
                                                initial_state=hf))
    assert len(basis) < len(states) <= cap             # externals added
    keys = set(h.keys(states).tolist())
    assert set(h.keys(basis).tolist()) <= keys         # basis contained
    assert int(h.keys(hf)[0]) in keys                  # init contained
    assert len(keys) == len(states)                    # dedup
    pa = np.array([bin(int(r[0])).count("1") for r in states])
    pb = np.array([bin(int(r[1])).count("1") for r in states])
    assert np.all(pa == h.n_alpha) and np.all(pb == h.n_beta)


def test_build_restricted_subspace_overflowing_basis(lih):
    """A basis larger than the cap keeps its top-|c| rows."""
    jh, h = lih
    basis = _seed_basis(h, 40)
    hf = h.get_hf_state()[None, :]
    states = skqd.build_restricted_subspace(h, basis, 16, initial_state=hf)
    np.testing.assert_array_equal(
        states, jskqd.build_restricted_subspace(jh, basis, 16,
                                                initial_state=hf))
    assert len(states) <= 16
    assert int(h.keys(hf)[0]) in set(h.keys(states).tolist())


@pytest.mark.parametrize("n", [8, 24])
def test_rank_external_candidates_matches_jax(lih, n):
    jh, h = lih
    basis = _seed_basis(h, n)
    cand, scores, e, coeffs = pre.SelectedCIExpander(
        h).rank_external_candidates(basis)
    jcand, jscores, je, jcoeffs = jre.SelectedCIExpander(
        jh).rank_external_candidates(basis)
    np.testing.assert_array_equal(h.keys(cand), jh.keys(jcand))
    np.testing.assert_allclose(scores, jscores, rtol=1e-6, atol=0)
    assert abs(e - je) < 1e-10
    np.testing.assert_allclose(np.abs(coeffs), np.abs(jcoeffs), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("evolution", ["scipy", "dense", "ell"])
def test_restricted_skqd_discovers_and_improves(lih, evolution):
    """Restricted evolution must sample determinants outside the weak
    seed basis (HF + 7 connections), improve on its energy by more than
    half the gap to FCI, and stay variational."""
    _, h = lih
    fci = h.fci_energy()
    basis = _seed_basis(h, 8)
    e_seed = float(h.exact_ground_state(basis, k=1)[0][0])
    states = skqd.build_restricted_subspace(h, basis, 150,
                                            initial_state=h.get_hf_state())
    s = skqd.FlowGuidedSKQD(
        h, basis,
        skqd.SKQDConfig(max_krylov_dim=6, shots_per_krylov=20_000, seed=0,
                        time_step=0.4, evolution=evolution),
        initial_state=h.get_hf_state(), subspace_states=states)
    assert s.restricted and not s.use_trotter
    assert s.dim == len(states) < h.n_valid_configs
    out = s.run_with_nf()
    e = out["best_stable_energy"]
    assert e <= e_seed + 1e-9
    assert e >= fci - 1e-9                              # variational
    assert e - fci < (e_seed - fci) * 0.5               # real improvement
    assert out["combined_sizes"][-1] > len(basis)       # discovery


def test_run_with_nf_final_only(lih):
    _, h = lih
    basis = _seed_basis(h, 8)
    states = skqd.build_restricted_subspace(h, basis, 60,
                                            initial_state=h.get_hf_state())
    cfg = skqd.SKQDConfig(max_krylov_dim=4, shots_per_krylov=5000,
                          time_step=0.4, evolution="ell")
    kw = dict(initial_state=h.get_hf_state(), subspace_states=states)
    every = skqd.FlowGuidedSKQD(h, basis, cfg, **kw).run_with_nf()
    last = skqd.FlowGuidedSKQD(h, basis, cfg, **kw).run_with_nf(
        final_only=True)
    assert len(every["combined_energies"]) == 4
    assert len(last["combined_energies"]) == 1
    assert last["combined_energies"][0] == every["combined_energies"][-1]
    assert last["krylov_basis_sizes"] == every["krylov_basis_sizes"]


def test_restricted_ell_membership(lih):
    """The device ELL build on two-word molecular keys: the table's
    product equals the host sparse matrix of the restricted space (5e-4,
    the JAX test's float32 tolerance at |H| ~ 8)."""
    _, h = lih
    basis = _seed_basis(h, 20)
    states = skqd.build_restricted_subspace(h, basis, 100,
                                            initial_state=h.get_hf_state())
    s = skqd.FlowGuidedSKQD(h, basis, skqd.SKQDConfig(evolution="ell"),
                            initial_state=h.get_hf_state(),
                            subspace_states=states)
    diag, elems_t, tgt_t = (a.numpy() for a in s._ell_structure())
    v = np.random.default_rng(0).normal(size=s.dim).astype(np.float32)
    Hv = diag * v
    for c in range(elems_t.shape[0]):
        np.add.at(Hv, tgt_t[c], elems_t[c] * v)
    assert np.abs(Hv - s.subspace_hamiltonian.toarray() @ v).max() < 5e-4


def test_pipeline_routes_restricted_skqd(lih, monkeypatch):
    """With the full space declared too large, stage 4 runs the
    restricted route.  A poor stage-3 result is injected so that the
    accuracy-based skip rules cannot fire."""
    from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                                   PipelineConfig)
    _, h = lih
    fci = h.fci_energy()
    cfg = PipelineConfig(max_krylov_dim=4, shots_per_krylov=10_000,
                         verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=fci)
    monkeypatch.setattr(pipe, "_supported_evolution_dim", lambda: 180)
    pipe.n_valid = 300_000
    seed = _seed_basis(h, 4)
    e_seed = float(h.exact_ground_state(seed, k=1)[0][0])
    assert e_seed - fci > 2e-3               # poor enough not to skip
    pipe.nf_basis = seed
    pipe.results["stage3"] = {"energy": e_seed, "basis": seed}
    out = pipe.run_skqd()
    assert not out["skipped"]
    assert 0 < out["restricted_dim"] <= 180
    assert fci - 1e-9 <= out["final_energy"] <= e_seed + 1e-9


def test_pipeline_skips_when_the_cap_leaves_no_room(lih, monkeypatch):
    from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                                   PipelineConfig)
    _, h = lih
    pipe = FlowGuidedKrylovPipeline(h, PipelineConfig(verbose=False),
                                    exact_energy=h.fci_energy())
    monkeypatch.setattr(pipe, "_supported_evolution_dim", lambda: 10)
    pipe.n_valid = 300_000
    seed = _seed_basis(h, 8)
    pipe.nf_basis = seed
    pipe.results["stage3"] = {"energy": -7.0, "basis": seed}
    out = pipe.run_skqd()
    assert out["skipped"] and "leaves no room" in out["reason"]
