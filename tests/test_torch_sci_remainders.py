"""Port parity: the Selected-CI remainders (``growth_factor``,
``source_screen``, ``pt2_sort_rows``, ``use_pt2=False`` and
``ResidualBasedExpander``) and the device PT2 scorer on one-word spin
configurations, against the JAX package on the CPU.

Trajectories are held round by round: the same basis keys in the same
order, f64 energies to 1e-9 Ha."""

import dataclasses

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import residual_expansion as pre

torch.set_num_threads(1)

E_TOL = 1e-9


def _hams(name):
    if name == "heisenberg12":
        jh = jspin.HeisenbergHamiltonian(12, 1.0, 1.0, 1.0,
                                         h_z=np.array([0.1] + [0.0] * 11))
        ph = convert.spin_hamiltonian_from_jax(jh, "cpu")
        start = np.array([[sum(1 << i for i in range(0, 12, 2))]], np.uint32)
    elif name == "tfim10":
        jh = jspin.TransverseFieldIsing(10, V=1.0, h=0.5, periodic=True)
        ph = convert.spin_hamiltonian_from_jax(jh, "cpu")
        # up spins on sites 0, 1, 3, a set no rotation or reflection of
        # the ring maps to itself: from |0...0> whole symmetry orbits of
        # candidates score alike, and float32 rounding orders the ties
        start = np.array([[0b1011]], np.uint32)
    else:
        jh = jmol.create_lih_hamiltonian()
        ph = pmol.MolecularHamiltonian(jh.integrals, "cpu")
        start = jh.get_hf_state()[None, :]
    return jh, ph, start


def _assert_same(pout, jout):
    np.testing.assert_array_equal(pout["basis"], jout["basis"])
    np.testing.assert_allclose(pout["energies"], jout["energies"], rtol=0,
                               atol=E_TOL)
    assert pout["n_iterations"] == jout["n_iterations"]


def test_config_fields_match_jax():
    assert (dataclasses.asdict(pre.ResidualExpansionConfig())
            == dataclasses.asdict(jre.ResidualExpansionConfig()))


# (name, config): growth_factor and source_screen through the loop
LOOPS = [
    ("heisenberg12", dict(configs_per_iteration=10, max_iterations=6,
                          growth_factor=0.5, residual_threshold=1e-6,
                          max_basis_size=600)),
    ("lih", dict(configs_per_iteration=8, max_iterations=6,
                 growth_factor=0.5, residual_threshold=1e-6,
                 max_basis_size=200)),
    ("heisenberg12", dict(configs_per_iteration=20, max_iterations=5,
                          source_screen=5.0, residual_threshold=1e-3,
                          max_basis_size=600)),
    ("lih", dict(configs_per_iteration=10, max_iterations=5,
                 source_screen=2.0, residual_threshold=1e-3,
                 max_basis_size=200)),
]


@pytest.mark.parametrize("name,cfg", LOOPS,
                         ids=[f"{n}-{'growth' if 'growth_factor' in c else 'screen'}"
                              for n, c in LOOPS])
def test_iterative_expansion_matches_jax(name, cfg):
    jh, ph, start = _hams(name)
    jout = jre.iterative_residual_expansion(
        jh, start, jre.ResidualExpansionConfig(**cfg))
    pout = pre.iterative_residual_expansion(
        ph, start, pre.ResidualExpansionConfig(**cfg))
    _assert_same(pout, jout)
    if "growth_factor" in cfg:
        # proportional rounds add more than the fixed schedule can
        assert len(pout["basis"]) > len(start) + cfg[
            "configs_per_iteration"] * pout["n_iterations"]


@pytest.mark.parametrize("name", ["heisenberg12", "lih"])
def test_source_screen_drops_small_sources(name):
    """The screen scores fewer sources than the unscreened round, from a
    Hmax sampled once, as the JAX expander does."""
    jh, ph, start = _hams(name)
    cfg = dict(configs_per_iteration=30, max_iterations=3,
               residual_threshold=1e-6, max_basis_size=600)
    basis = pre.iterative_residual_expansion(
        ph, start, pre.ResidualExpansionConfig(**cfg))["basis"]
    plain = pre.SelectedCIExpander(ph, pre.ResidualExpansionConfig(**cfg))
    e, coeffs = plain._diagonalize(basis)
    screen = pre.SelectedCIExpander(ph, pre.ResidualExpansionConfig(
        **dict(cfg, source_screen=2e4)))
    jscreen = jre.SelectedCIExpander(jh, jre.ResidualExpansionConfig(
        **dict(cfg, source_screen=2e4)))
    cand, scores = screen._pt2_candidates(basis, coeffs, e)
    jcand, jscores = jscreen._pt2_candidates(basis, coeffs, e)
    np.testing.assert_array_equal(cand, jcand)
    np.testing.assert_allclose(scores, jscores, rtol=1e-12, atol=0)
    assert screen._hmax == jscreen._hmax > 0
    full, _ = plain._pt2_candidates(basis, coeffs, e)
    assert len(cand) < len(full)


def _device_trajectory(h, cfg, start, rounds, jax_pkg):
    mod = jre if jax_pkg else pre
    exp = mod.SelectedCIExpander(h, mod.ResidualExpansionConfig(**cfg),
                                 use_device_scoring=True)
    basis, keys, energies = start, [], []
    for _ in range(rounds):
        out = exp.expand_basis(basis)
        basis = out["basis"]
        keys.append(h.keys(basis))
        energies.append(out["energy"])
        if not out["accepted"]:
            break
    return keys, energies


@pytest.mark.parametrize("name,sort_rows", [("heisenberg12", 300),
                                            ("lih", 500)])
def test_pt2_sort_rows_trajectory_matches_jax(name, sort_rows):
    """The row cap of the device scorer: an exact top-k of |c_j H_ij| whose
    ties keep the lower row, as the JAX scorer's on the CPU."""
    jh, ph, start = _hams(name)
    cfg = dict(configs_per_iteration=15, max_iterations=5,
               residual_threshold=1e-6, max_basis_size=200,
               pt2_sort_rows=sort_rows)
    jk, je = _device_trajectory(jh, cfg, start, 5, True)
    pk, pe = _device_trajectory(ph, cfg, start, 5, False)
    assert len(pk) == len(jk) >= 3
    for a, b in zip(pk, jk):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pe, je, rtol=0, atol=E_TOL)
    # the cap bites: its trajectory is not the uncapped one
    uk, _ = _device_trajectory(ph, dict(cfg, pt2_sort_rows=0), start, 5,
                               False)
    assert any(len(a) != len(b) or (a != b).any() for a, b in zip(pk, uk))


@pytest.mark.parametrize("name", ["heisenberg12", "lih"])
def test_residual_based_expander_matches_jax(name):
    jh, ph, start = _hams(name)
    cfg = dict(configs_per_iteration=12, max_iterations=5,
               residual_threshold=1e-5, max_basis_size=300)
    jout = jre.iterative_residual_expansion(
        jh, start, jre.ResidualExpansionConfig(**cfg), use_pt2=False)
    pout = pre.iterative_residual_expansion(
        ph, start, pre.ResidualExpansionConfig(**cfg), use_pt2=False,
        pt2_correct=True, pt2_checkpoints=[20])
    _assert_same(pout, jout)
    assert "pt2_de2" not in pout and "pt2_checkpoints" not in pout
    assert pout["n_iterations"] >= 3
    jx = jre.ResidualBasedExpander(jh, jre.ResidualExpansionConfig(**cfg))
    px = pre.ResidualBasedExpander(ph, pre.ResidualExpansionConfig(**cfg))
    basis = pout["basis"]
    vals, vecs = ph.exact_ground_state(basis, k=1)
    np.testing.assert_array_equal(
        px.find_residual_configs(basis, vecs[:, 0], 25),
        jx.find_residual_configs(basis, vecs[:, 0], 25))


# ---------------------------------------------------------------------------
# Fault 1 and 2: the device PT2 scorer on one-word configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["heisenberg12", "tfim10"])
def test_device_scorer_equals_host_scorer_on_spins(name):
    """One-word spin connections: the device scorer returns the host
    scorer's candidates, in the host's order, with f32-close scores
    (it paired neighbouring connections into two-word rows, and dropped
    half of them)."""
    jh, ph, start = _hams(name)
    cfg = dict(configs_per_iteration=40, max_iterations=3,
               residual_threshold=1e-6, max_basis_size=2000)
    basis = pre.iterative_residual_expansion(
        ph, start, pre.ResidualExpansionConfig(**cfg))["basis"]
    rcfg = pre.ResidualExpansionConfig(**cfg)
    host = pre.SelectedCIExpander(ph, rcfg, use_device_scoring=False)
    dev = pre.SelectedCIExpander(ph, rcfg, use_device_scoring=True)
    e, coeffs = host._diagonalize(basis)
    cand_h, sc_h = host._pt2_candidates(basis, coeffs, e)
    cand_d, sc_d = dev._pt2_candidates(basis, coeffs, e)
    assert cand_d.shape[1] == 1
    np.testing.assert_array_equal(cand_d, cand_h)
    np.testing.assert_allclose(sc_d, sc_h, rtol=1e-4, atol=1e-12)
    # and the raw block against the JAX package's device block
    sig = np.abs(coeffs) > rcfg.coefficient_threshold
    jdev = jre.SelectedCIExpander(jh, jre.ResidualExpansionConfig(**cfg),
                                  use_device_scoring=True)

    def merged(h, exp):
        c, coup = exp._pt2_topk_device(basis[sig], coeffs[sig])
        uniq, _, inv = jre._sorted_unique(h.keys(c), return_inverse=True)
        return uniq, np.bincount(inv, weights=coup, minlength=len(uniq))

    pk, pc = merged(ph, dev)
    jk, jc = merged(jh, jdev)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["heisenberg12", "tfim10"])
def test_device_scored_trajectory_matches_jax_on_spins(name):
    """Forced device scoring: the port's trajectory equals the JAX
    expander's, and holds the same states as its own host-scored one
    (float32 and float64 couplings may order a round's near-tied
    additions differently: TFIM's elements are all -h)."""
    jh, ph, start = _hams(name)
    cfg = dict(configs_per_iteration=25, max_iterations=5,
               residual_threshold=1e-6, max_basis_size=400)
    jk, je = _device_trajectory(jh, cfg, start, 5, True)
    pk, pe = _device_trajectory(ph, cfg, start, 5, False)
    hk, he = [], []
    host = pre.SelectedCIExpander(ph, pre.ResidualExpansionConfig(**cfg),
                                  use_device_scoring=False)
    basis = start
    for _ in range(5):
        out = host.expand_basis(basis)
        basis = out["basis"]
        hk.append(ph.keys(basis))
        he.append(out["energy"])
    assert len(pk) == len(jk) == len(hk) >= 3
    for a, b, c in zip(pk, jk, hk):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.sort(a), np.sort(c))
    np.testing.assert_allclose(pe, je, rtol=0, atol=E_TOL)
    np.testing.assert_allclose(pe, he, rtol=0, atol=E_TOL)


def test_device_scorer_has_no_atomic_sum():
    """The scorer sums each key's run with ``segment_reduce`` after a
    stable sort (no ``index_add_``), so two calls give the same bits."""
    import inspect
    src = inspect.getsource(pre.SelectedCIExpander._pt2_topk_device)
    assert "index_add" not in src and "_sum_by_key(" in src
    summed = inspect.getsource(pre._sum_by_key)
    assert "segment_reduce" in summed and "lex_order(" in summed
    assert "stable=True" in inspect.getsource(pre.lex_order)
    _, ph, start = _hams("heisenberg12")
    cfg = pre.ResidualExpansionConfig(configs_per_iteration=40,
                                      max_iterations=2)
    basis = pre.iterative_residual_expansion(ph, start, cfg)["basis"]
    e, coeffs = ph.exact_ground_state(basis, k=1)
    dev = pre.SelectedCIExpander(ph, cfg, use_device_scoring=True)
    a = dev._pt2_topk_device(basis, coeffs[:, 0])
    b = dev._pt2_topk_device(basis, coeffs[:, 0])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
