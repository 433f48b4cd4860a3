"""Restricted SKQD of the large-system CLI (``run_sci`` then
``run_restricted_skqd``) held to the benchmark's plain float64 reference
(``perfbench/reference/restricted.py``), on H2O/STO-3G (441
determinants): one SCI round from HF, its exact dE2, the restricted set
of its top-ranked externals, the ELL tables built on the device (the
plain version on the CPU), every evolved state, and the final energy.
The ELL route is forced, as it is taken past the dense cap on the card.
"""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from flow_guided_krylov_torch.chem.scf import MolecularIntegrals
from flow_guided_krylov_torch.examples import large_system_benchmark as lsb
from flow_guided_krylov_torch.hamiltonians.molecular import \
    MolecularHamiltonian
from flow_guided_krylov_torch.krylov import skqd
from perfbench.reference import restricted, slater
from perfbench.reference.eig import ground_energy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "perfbench/tests/data/h2o-sto3g.integrals.npz"
N_ORB, NA, NB = 7, 5, 5
K, SHOTS, DT = 6, 20_000, 0.1
Skqd = skqd.SampleBasedKrylovDiagonalization


@pytest.fixture(scope="module")
def h2o():
    h1, h2, e_nuc = slater.load_integrals(str(NPZ))
    h = MolecularHamiltonian(MolecularIntegrals(
        h1e=h1, h2e=h2, nuclear_repulsion=e_nuc, n_electrons=NA + NB,
        n_orbitals=N_ORB, n_alpha=NA, n_beta=NB), "cpu")
    ints = restricted.Integrals(h1, h2, e_nuc, NA, NB)
    sci = lsb.run_sci(h, None, iters=1)
    return h, ints, (h1, h2, e_nuc), sci


def _hf():
    return np.array([(1 << NA) - 1, (1 << NB) - 1], np.int64)


def _ell_route():
    """``evolve(auto)`` past the dense cap: the ELL propagator."""
    return mock.patch.object(Skqd, "_dense_evolution_cap", lambda self: 0)


def test_sci_energy_and_de2_are_the_reference(h2o):
    h, ints, _, sci = h2o
    basis = sci["_basis"]
    H, _ = restricted.hamiltonian(ints, basis)
    e, v = restricted.ground_state(H)
    assert abs(sci["final_energy"] - e) < 1e-10
    ref = restricted.pt2(ints, basis, v, e)
    assert sci["pt2_exact"]
    assert abs(sci["pt2_de2"] - ref["de2"]) < 1e-8
    assert ref["n_external"] > 0


@pytest.mark.parametrize("cap", [120, 10_000])
def test_restricted_set_is_the_basis_and_its_top_externals(h2o, cap):
    h, ints, _, sci = h2o
    basis = sci["_basis"]
    hf = h.get_hf_state()
    states = skqd.build_restricted_subspace(h, basis, cap, initial_state=hf)
    H, _ = restricted.hamiltonian(ints, basis)
    e, v = restricted.ground_state(H)
    ref = restricted.pt2(ints, basis, v, e)
    assert restricted.restricted_problems(
        states, basis, hf[None, :], cap, ref["externals"],
        ref["scores"]) == 0
    assert len(states) == min(cap - 1, len(basis) + ref["n_external"])
    # a set with its lowest-ranked external swapped for a worse one fails
    if cap < len(basis) + ref["n_external"]:
        k = lambda x: (np.asarray(x, np.int64)[:, 0] << 32) | np.asarray(
            x, np.int64)[:, 1]                       # noqa: E731
        out = ~np.isin(k(ref["externals"]), k(states))
        worst = ref["externals"][out][np.argmin(ref["scores"][out])]
        bad = states.astype(np.int64).copy()
        bad[-1] = worst
        assert restricted.restricted_problems(
            bad, basis, hf[None, :], cap, ref["externals"],
            ref["scores"]) > 0


def _solver(h, basis, states, seed=0):
    return skqd.FlowGuidedSKQD(
        h, basis, skqd.SKQDConfig(max_krylov_dim=K, shots_per_krylov=SHOTS,
                                  time_step=DT, seed=seed,
                                  evolution="ell"),
        initial_state=h.get_hf_state(), subspace_states=states)


def test_ell_tables_are_the_reference_rows(h2o):
    h, ints, _, sci = h2o
    states = skqd.build_restricted_subspace(h, sci["_basis"], 300,
                                            initial_state=h.get_hf_state())
    s = _solver(h, sci["_basis"], states)
    diag, elems, tgt = s._build_ell_device(states)
    N = len(states)
    got = np.zeros((N, N))
    np.add.at(got, (np.arange(N)[None, :].repeat(elems.shape[0], 0),
                    tgt.numpy()), elems.double().numpy())
    H, dg = restricted.hamiltonian(ints, states)
    want = H.to_dense().numpy()
    want[np.arange(N), np.arange(N)] = 0.0
    # float32 tables: each element within a float32 rounding or two, the
    # diagonal (about -75 Ha, summed in float32) within a few
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-7)
    np.testing.assert_allclose(diag.double().numpy(), dg.numpy(),
                               rtol=5e-7)


def test_evolved_states_and_final_energy_are_the_reference(h2o):
    h, ints, (h1, h2, e_nuc), sci = h2o
    basis = sci["_basis"]
    states = skqd.build_restricted_subspace(h, basis, 300,
                                            initial_state=h.get_hf_state())
    s = _solver(h, basis, states, seed=5)
    evolved, combined = [], []
    evolve, combine = Skqd.evolve, skqd.FlowGuidedSKQD.get_combined_basis

    def kept(obj, psi):
        evolved.append(evolve(obj, psi))
        return evolved[-1]

    def combined_kept(obj, kb):
        combined.append(combine(obj, kb))
        return combined[-1]

    with mock.patch.object(Skqd, "evolve", kept), \
            mock.patch.object(skqd.FlowGuidedSKQD, "get_combined_basis",
                              combined_kept):
        out = s.run_with_nf(final_only=True)
    H, dg = restricted.hamiltonian(ints, states)
    start = int(np.flatnonzero(
        restricted.keys_of(torch.as_tensor(states[:, 0].astype(np.int64)),
                           torch.as_tensor(states[:, 1].astype(np.int64)))
        .numpy() == ((int(_hf()[0]) << 32) | int(_hf()[1])))[0])
    assert len(evolved) == K - 1
    for psi, (_, re, im) in zip(evolved, restricted.krylov_states(
            H, dg, start, K - 1, DT)):
        want = re.numpy() + 1j * im.numpy()
        assert np.abs(psi / np.linalg.norm(psi) - want).max() < 5e-5
    Hc = slater.projected_hamiltonian(np.asarray(combined[-1], np.int64),
                                      N_ORB, NA, NB, h1, h2, e_nuc)
    assert abs(out["best_stable_energy"] - ground_energy(Hc)) < 1e-9
    assert out["best_stable_energy"] <= sci["final_energy"] + 1e-12


def _restricted_skqd(h2o, **kw):
    h, _, _, sci = h2o
    draws = []
    cumulative = Skqd.build_cumulative_basis

    def kept(obj, samples):
        draws.append(samples)
        return cumulative(obj, samples)

    with _ell_route(), mock.patch.object(Skqd, "build_cumulative_basis",
                                         kept):
        out = lsb.run_restricted_skqd(h, None, sci["_basis"],
                                      sci["final_energy"], shots=SHOTS,
                                      **kw)
    out.pop("skqd_wall_s")
    return out, draws[0]


def test_seed_zero_is_the_default(h2o):
    """``seed=0`` is the CLI's run as it was before the argument: the
    draws of ``SKQDConfig``'s default seed, bit for bit."""
    default, d0 = _restricted_skqd(h2o)
    zero, z0 = _restricted_skqd(h2o, seed=0)
    assert default == zero and d0 == z0
    h, _, _, sci = h2o
    states = skqd.build_restricted_subspace(
        h, sci["_basis"], skqd.supported_evolution_dim(h),
        initial_state=h.get_hf_state())
    with _ell_route():
        before = skqd.FlowGuidedSKQD(
            h, sci["_basis"], skqd.SKQDConfig(
                max_krylov_dim=K, shots_per_krylov=SHOTS, time_step=DT),
            initial_state=h.get_hf_state(),
            subspace_states=states).run_with_nf(final_only=True)
    assert zero["skqd_energy"] == before["best_stable_energy"]
    assert zero["skqd_combined_size"] == before["combined_sizes"][-1]


def test_two_seeds_draw_differently(h2o):
    (a, da), (b, db) = (_restricted_skqd(h2o, seed=s) for s in (0, 1))
    assert len(da) == len(db) == K
    # the first draw is the HF state's alone; the later ones differ
    assert da[0] == db[0]
    assert all(x != y for x, y in zip(da[1:], db[1:]))
