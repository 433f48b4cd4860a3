"""The plain reference against exact values it does not share code with:
published FCI energies, dense diagonalization, scipy's matrix exponential
and, at small sizes, the program itself."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import torch

from perfbench.reference import slater, tfim
from perfbench.reference.eig import ground_energy

ROOT = Path(__file__).resolve().parents[2]


def ch4():
    conf = json.loads((ROOT / "perfbench/configs/ch4-sto3g.json").read_text())
    return conf, slater.load_integrals(str(ROOT / conf["integrals"]))


def test_ch4_fci_is_the_published_value():
    conf, (h1, h2, e_nuc) = ch4()
    e = slater.fci_energy(9, 5, 5, h1, h2, e_nuc)
    assert abs(e - conf["fci_energy_published"]) < 1e-6


def test_ch4_hamiltonian_is_symmetric_with_all_connections():
    _, (h1, h2, e_nuc) = ch4()
    dets = slater.all_determinants(9, 5, 5)
    H = slater.projected_hamiltonian(dets, 9, 5, 5, h1, h2, e_nuc)
    assert abs(H - H.T).max() < 1e-12
    # 560 connections a determinant, plus the diagonal
    assert H.nnz == len(dets) * 561


def test_h2o_matches_the_program():
    from flow_guided_krylov_torch.hamiltonians.molecular import \
        MOLECULE_FACTORIES
    h = MOLECULE_FACTORIES["h2o"]("cpu")
    i = h.integrals
    basis = h.enumerate_basis()[::3].astype(np.int64)
    H = slater.projected_hamiltonian(basis, 7, 5, 5, i.h1e, i.h2e,
                                     i.nuclear_repulsion)
    e_ref = ground_energy(H)
    e_prog = float(h.exact_ground_state(basis.astype(np.uint32), k=1)[0][0])
    assert abs(e_ref - e_prog) < 1e-9
    assert abs(slater.fci_energy(7, 5, 5, i.h1e, i.h2e, i.nuclear_repulsion)
               - h.fci_energy()) < 1e-9


def test_basis_problems_counts_each_fault():
    dets = slater.all_determinants(7, 5, 5)[:10]
    assert slater.basis_problems(dets, 7, 5, 5) == 0
    bad = dets.copy()
    bad[0, 0] ^= 1                     # one electron too few or many
    bad[1] = bad[2]                    # a repeat
    assert slater.basis_problems(bad, 7, 5, 5) == 2


@pytest.mark.parametrize("n, h", [(8, 0.5), (10, 1.0), (12, 0.3)])
def test_free_fermion_energy_is_the_dense_ground_state(n, h):
    H = tfim.projected_hamiltonian(np.arange(1 << n), n, 1.0, h)
    assert abs(np.linalg.eigvalsh(H.toarray())[0]
               - tfim.free_fermion_energy(n, 1.0, h)) < 1e-10


def test_trotter_states_follow_the_exact_propagator():
    n, h, dt = 8, 0.5, 0.1
    H = tfim.projected_hamiltonian(np.arange(1 << n), n, 1.0, h).toarray()
    U = scipy.linalg.expm(-1j * dt * H)
    psi = np.zeros(1 << n, complex)
    psi[0] = 1.0
    for k, re, im in tfim.krylov_states(n, 1.0, h, dt, 8, 3, "cpu"):
        psi = U @ psi
        got = re.numpy() + 1j * im.numpy()
        # second-order Trotter: an error of order dt^3 / substeps^2
        assert np.abs(got - psi).max() < 1e-4
        assert abs(np.linalg.norm(got) - 1) < 1e-12


def test_trotter_states_match_the_program():
    from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
    from flow_guided_krylov_torch.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    from flow_guided_krylov_torch.hamiltonians.spin import pack_spin_state
    n = 12
    ham = TransverseFieldIsing(n, V=1.0, h=0.5, periodic=True, device="cpu")
    skqd = SampleBasedKrylovDiagonalization(
        ham, SKQDConfig(evolution="trotter", time_step=0.1),
        initial_state=pack_spin_state(0, n))
    re = torch.zeros(1 << n)
    re[0] = 1.0
    im = torch.zeros_like(re)
    for k, rr, ri in tfim.krylov_states(n, 1.0, 0.5, 0.1, 8, 3, "cpu"):
        re, im = skqd._evolve_trotter(re, im)
        assert torch.hypot(re.double() - rr, im.double() - ri).max() < 1e-5


def test_bfloat16_control_is_far_from_the_reference():
    n = 12
    f64 = tfim.krylov_states(n, 1.0, 0.5, 0.1, 8, 2, "cpu")
    bf16 = tfim.krylov_states(n, 1.0, 0.5, 0.1, 8, 2, "cpu",
                              dtype=torch.bfloat16)
    for (_, r, i), (_, cr, ci) in zip(f64, bf16):
        assert torch.hypot(r - cr.double(), i - ci.double()).max() > 1e-3


def test_weight_probabilities_sum_to_one():
    n = 12
    weights = tfim.popcount(torch.arange(1 << n), n)
    for k, re, im in tfim.krylov_states(n, 1.0, 0.5, 0.1, 8, 2, "cpu"):
        p = tfim.weight_probabilities(re, im, weights, n)
        assert abs(p.sum() - 1) < 1e-12 and p[0] > 0.5


def test_nqs_log_amplitudes_are_the_programs():
    from flow_guided_krylov_torch.models.dense import DenseNQS
    from perfbench.reference import nqs
    model = DenseNQS(14, hidden_dims=(32, 32),
                     generator=torch.Generator().manual_seed(3))
    dets = slater.all_determinants(7, 5, 5)[::7]
    occ = nqs.occupations(dets, 7)
    with torch.no_grad():
        want = model(torch.tensor(occ, dtype=torch.float32)).double()
    params = [(k, v.detach().double()) for k, v in model.named_parameters()]
    got = nqs.log_amplitudes(params, torch.tensor(occ), tf32=False)
    assert torch.abs(got - want).max() < 1e-6


def test_tf32_control_rounds_to_ten_mantissa_bits():
    from perfbench.reference.nqs import _tf32
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]
