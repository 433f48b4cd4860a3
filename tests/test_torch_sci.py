"""Port parity: HF-seeded Selected-CI trajectories and the device PT2
scoring block, against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import residual_expansion as pre

torch.set_num_threads(1)


def _integrals(name):
    if name == "synthetic(8,3,3)":
        return pmol.synthetic_integrals(8, 3, 3, seed=7)
    return jmol.MOLECULE_FACTORIES[name]().integrals


def _trajectory(h, expander, rounds):
    """bench.py's HF-seeded loop: basis keys and energy of every round."""
    basis = h.get_hf_state()[None, :]
    keys, energies = [], []
    for _ in range(rounds):
        out = expander.expand_basis(basis)
        basis = out["basis"]
        keys.append(h.keys(basis))
        energies.append(out["energy"])
        if not out["accepted"]:
            break
    return keys, energies


# (system, configs per round, rounds): the synthetic run passes 2048 dets,
# which moves the eigensolve to warm Davidson on the incremental sparse H
CASES = [("lih", 10, 8), ("h2o", 30, 6), ("synthetic(8,3,3)", 500, 6)]


@pytest.mark.parametrize("name,per_round,rounds", CASES,
                         ids=[c[0] for c in CASES])
def test_selected_ci_trajectory_matches_jax(name, per_round, rounds):
    ints = _integrals(name)
    cfg = dict(configs_per_iteration=per_round, max_iterations=rounds)
    jh = jmol.MolecularHamiltonian(ints)
    ph = pmol.MolecularHamiltonian(ints, device="cpu")
    jk, je = _trajectory(jh, jre.SelectedCIExpander(
        jh, jre.ResidualExpansionConfig(**cfg)), rounds)
    pk, pe = _trajectory(ph, pre.SelectedCIExpander(
        ph, pre.ResidualExpansionConfig(**cfg)), rounds)
    assert len(pk) == len(jk) >= 2
    for a, b in zip(pk, jk):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pe, je, rtol=0, atol=1e-9)
    if name == "synthetic(8,3,3)":
        assert len(pk[-1]) > 2048


def test_device_pt2_block_matches_jax():
    """Forced device scoring over one H2O basis: after the host's grouped
    merge, the same candidate keys with float32-close couplings."""
    ints = _integrals("h2o")
    jh = jmol.MolecularHamiltonian(ints)
    ph = pmol.MolecularHamiltonian(ints, device="cpu")
    cfg = dict(configs_per_iteration=40, max_iterations=3)
    res = jre.iterative_residual_expansion(
        jh, jh.get_hf_state()[None, :], jre.ResidualExpansionConfig(**cfg))
    basis = res["basis"]
    je = jre.SelectedCIExpander(jh, jre.ResidualExpansionConfig(**cfg),
                                use_device_scoring=True)
    pe = pre.SelectedCIExpander(ph, pre.ResidualExpansionConfig(**cfg),
                                use_device_scoring=True)
    _, coeffs = je._diagonalize(basis)
    src = basis[np.abs(coeffs) > 1e-6]
    src_c = coeffs[np.abs(coeffs) > 1e-6]

    def merged(h, exp):
        cand, coup = exp._pt2_topk_device(src, src_c)
        uniq, first, inv = jre._sorted_unique(h.keys(cand),
                                              return_inverse=True)
        return uniq, np.bincount(inv, weights=coup, minlength=len(uniq))

    jk, jc = merged(jh, je)
    pk, pc = merged(ph, pe)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-6)
    # the port's device scoring ranks like its host scoring
    e0, c0 = pe._diagonalize(basis)
    cand_d, sc_d = pe._pt2_candidates(basis, c0, e0)
    pe.use_device_scoring = False
    cand_h, sc_h = pe._pt2_candidates(basis, c0, e0)
    np.testing.assert_array_equal(ph.keys(cand_d), ph.keys(cand_h))
    np.testing.assert_allclose(sc_d, sc_h, rtol=1e-4, atol=1e-9)
