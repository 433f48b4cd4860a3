"""Port parity: SKQD over 4-word determinants (more than 32 orbitals)
against the JAX package on the CPU.

The system is a 6-orbital (2a, 2b) one embedded in 34 orbitals (W = 4,
C = 5,216), as in ``tests/test_torch_multiword.py``; the restricted
subspace is 160 of its 225 determinants, HF among them.  Held to:

* the device ELL build's targets: bit-equal to the JAX package's host
  build where a connection lands in the subspace; a connection that
  leaves it gets element 0 and target 0 in the port;
* elements and diagonal: ``ELEM_TOL``; one evolve: ``EVOLVE_RTOL``
  (relative 2-norm) of the JAX package's dense evolve.  Its ELL evolve is
  not the yardstick: its host build at W = 4 keeps the elements of
  connections that leave the subspace and points them at the searched
  position, a fault of the reference (ROADMAP.md, Queue 3);
* ``compute_ground_state_energy`` on one given set: ``ENERGY_TOL``;
* a run on the embedded system: the energies of the same run on the
  6-orbital system (two words a row), within ``ENERGY_TOL``;
* ``build_connection_table`` at W = 4: None, as in the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.krylov import skqd as jsk
from flow_guided_krylov_tpu.utils import connection_table as jct
from flow_guided_krylov_torch.hamiltonians.base import _KeyIndex, lex_order
from flow_guided_krylov_torch.krylov import skqd as psk
from flow_guided_krylov_torch.utils import connection_table as pct

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_multiword import _embed, _pair, _random_ints, _widen  # noqa

torch.set_num_threads(1)

ELEM_TOL = 2e-5          # float32 elements, |h| ~ 1
EVOLVE_RTOL = 1e-5       # float32 propagators, relative 2-norm
ENERGY_TOL = 1e-8        # host float64 eigensolves of the same matrix


@pytest.fixture(scope="module")
def system():
    ints6 = _random_ints(6, 2, 2, seed=7)
    jh6, ph6 = _pair(ints6)
    jh, ph = _pair(_embed(ints6, 34))
    full6 = ph6.enumerate_basis()
    hf6 = ph6.get_hf_state()
    keep = np.sort(np.random.default_rng(0).choice(len(full6), 160,
                                                   replace=False))
    st6 = full6[keep]
    if not (ph6.keys(st6) == ph6.keys(hf6[None])).any():
        st6 = np.concatenate([hf6[None], st6[:-1]])
    return dict(jh=jh, ph=ph, ph6=ph6, st6=st6, hf6=hf6, st4=_widen(st6),
                hf4=_widen(hf6[None])[0])


def _port(s, evolution="ell", **kw):
    cfg = psk.SKQDConfig(evolution=evolution, max_krylov_dim=3,
                         shots_per_krylov=5000, seed=3, **kw)
    return psk.FlowGuidedSKQD(s["ph"], s["st4"], cfg, initial_state=s["hf4"],
                              subspace_states=s["st4"])


def _jax(s, evolution):
    return jsk.FlowGuidedSKQD(s["jh"], s["st4"],
                              jsk.SKQDConfig(evolution=evolution),
                              initial_state=s["hf4"],
                              subspace_states=s["st4"])


def test_w4_device_ell_targets_match_jax_host_build(system):
    s = system
    assert s["ph"].pack_words == 4 and s["ph"].n_connections == 5216
    js = _jax(s, "ell")
    jd, je, jt = (np.asarray(a) for a in js._ell_structure())
    pd, pe, pt = (a.numpy() for a in _port(s)._ell_structure())
    # the JAX build's own membership of each connection
    conn, el = s["jh"].connections_np(s["st4"])
    ck = s["jh"].keys(conn.reshape(-1, 4))
    pos = np.clip(np.searchsorted(js._sorted_keys, ck), 0, len(s["st4"]) - 1)
    hit = (js._sorted_keys[pos] == ck).reshape(el.shape).T
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(pt[hit], jt[hit])
    assert (pe[~hit] == 0).all() and (pt[~hit] == 0).all()
    # the reference fault: misses keep their elements in the JAX build
    assert (np.abs(je[~hit]) > 0).any()
    assert np.abs(pe[hit] - je[hit]).max() < ELEM_TOL
    assert np.abs(pd - jd).max() < ELEM_TOL


def test_pair_search_equals_lexicographic_search():
    """The composite-rank search (``_KeyIndex`` over ``_PairKeys``) finds
    what a lexicographic two-key search finds, bit for bit, misses
    included."""
    rng = np.random.default_rng(1)
    a = rng.integers(-5, 5, 400) * (1 << 40)
    b = rng.integers(-(1 << 62), 1 << 62, 400)
    own = torch.as_tensor(np.unique(np.stack([a, b], -1)[:300], axis=0))
    own = own[torch.randperm(len(own), generator=torch.Generator()
                             .manual_seed(0))]
    query = torch.as_tensor(np.stack([a, b], -1))
    index = _KeyIndex(own)
    row, hit = index.find(query)
    got = torch.where(hit, row, -1)
    # lexicographic: the own pairs in lex order, each query searched by
    # its (a, b) tuple
    lex = lex_order(own)
    table = {tuple(own[i].tolist()): int(i) for i in lex}
    want = torch.tensor([table.get(tuple(q.tolist()), -1) for q in query])
    assert torch.equal(got, want)
    # the composite orders the pairs as the lexicographic order does
    assert torch.equal(index.order, lex)


def test_w4_evolve_matches_jax_dense(system):
    s = system
    ps = _port(s)
    psi = np.zeros(len(s["st4"]), complex)
    psi[ps._index_of(s["hf4"])[0]] = 1.0
    ref = _jax(s, "dense").evolve(psi)
    for out in (ps.evolve(psi), _port(s, "dense").evolve(psi)):
        assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < EVOLVE_RTOL
    scipy = ps._evolve_scipy(psi)
    assert np.linalg.norm(scipy - ref) / np.linalg.norm(ref) < EVOLVE_RTOL


def test_w4_ground_state_energy_matches_jax(system):
    s = system
    basis = s["st4"][::2]
    e_p = _port(s).compute_ground_state_energy(basis)
    e_j = _jax(s, "ell").compute_ground_state_energy(basis)
    assert abs(e_p - e_j) < ENERGY_TOL


def test_w4_run_equals_unembedded_w2_run(system):
    """The same restricted SKQD on the embedded (W = 4) and the 6-orbital
    (W = 2) system: the connections that reach the 28 empty orbitals carry
    zero elements, so the subspace Hamiltonians are equal."""
    s = system
    r4 = _port(s).run_with_nf()
    cfg = psk.SKQDConfig(evolution="ell", max_krylov_dim=3,
                         shots_per_krylov=5000, seed=3)
    r2 = psk.FlowGuidedSKQD(s["ph6"], s["st6"], cfg, initial_state=s["hf6"],
                            subspace_states=s["st6"]).run_with_nf()
    assert abs(r4["nf_only_energy"] - r2["nf_only_energy"]) < ENERGY_TOL
    np.testing.assert_allclose(r4["combined_energies"],
                               r2["combined_energies"], rtol=0,
                               atol=ENERGY_TOL)
    assert abs(r4["final_energy"] - r2["final_energy"]) < ENERGY_TOL


def test_w4_unrestricted_space_takes_the_device_build():
    """An enumerable 4-word space (one alpha, one beta electron in 33
    orbitals: 1,089 determinants) has no connection table; its ELL
    tables are built on the device over the enumerated states, and the
    evolve meets the JAX package's (dense: its ELL route has no table
    either)."""
    jh, ph = _pair(_random_ints(33, 1, 1, seed=4))
    assert ph.pack_words == 4 and ph.n_valid_configs == 1089
    assert pct.build_connection_table(ph) is None
    ps = psk.SampleBasedKrylovDiagonalization(
        ph, psk.SKQDConfig(evolution="ell"))
    psi = np.zeros(ps.dim, complex)
    psi[ps._index_of(ph.get_hf_state())[0]] = 1.0
    out = ps.evolve(psi)
    assert ps._ell[1].shape == (ph.n_connections, 1089)
    js = jsk.SampleBasedKrylovDiagonalization(
        jh, jsk.SKQDConfig(evolution="dense"))
    ref = js.evolve(psi)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < EVOLVE_RTOL


def test_w4_connection_table_is_none_as_in_jax(system):
    assert pct.build_connection_table(system["ph"]) is None
    assert jct.build_connection_table(system["jh"]) is None


def test_w4_restricted_cli_path(system):
    """``large_system_benchmark.run_restricted_skqd`` on the embedded
    system: the restricted subspace holds only the 6-orbital space (the
    externals through empty orbitals couple with 0) and the energy meets
    the same call on the 6-orbital system."""
    from flow_guided_krylov_torch.examples import large_system_benchmark \
        as lsb
    s = system
    basis4, basis6 = s["st4"][:40], s["st6"][:40]
    e6 = float(s["ph6"].exact_ground_state(basis6)[0][0])
    r4 = lsb.run_restricted_skqd(s["ph"], None, basis4, e6, krylov_dim=2,
                                 shots=5000)
    r2 = lsb.run_restricted_skqd(s["ph6"], None, basis6, e6, krylov_dim=2,
                                 shots=5000)
    assert r4["skqd_restricted_dim"] == r2["skqd_restricted_dim"] <= 225
    assert abs(r4["skqd_energy"] - r2["skqd_energy"]) < ENERGY_TOL
    assert r4["skqd_energy"] <= e6 + ENERGY_TOL
