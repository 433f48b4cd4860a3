"""Port parity: the exact Epstein-Nesbet dE2
(``SelectedCIExpander.pt2_correction``) against the JAX package on the
CPU.

The host closure is the same f64 NumPy in both packages: dE2 to 1e-8 Ha
and equal external counts.  The device block sums float32 couplings:
1e-6 Ha against the host and against the JAX device block.  An external
count can differ from the host's only by couplings that cancel by
symmetry: a float32 sum resolves some of them to an exact zero (dropped)
and some to a residue of ~1e-9 (kept, weightless), depending on the order
of the sum.  So the port's device externals are held to the host's key by
key: a subset, at most a thousandth fewer, and every one missing a
coupling below float32 resolution of its terms (``CANCEL_RTOL``) or of
its own square (``SQUARE_UNDERFLOW``).  The JAX device block returns no
keys: its count lies between the host's externals above those
resolutions and all of them.
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import residual_expansion as pre
from flow_guided_krylov_torch.ops.bits import to_device

torch.set_num_threads(1)

HOST_TOL = 1e-8
DEVICE_TOL = 1e-6
# a float32 sum of terms t_i resolves nothing below ~1e-7 * sum |t_i|
CANCEL_RTOL = 1e-6
# and a coupling below this squares to a subnormal float32 score, which a
# device may flush to 0 (symmetry-forbidden sources, coefficients ~1e-17)
SQUARE_UNDERFLOW = 1.1e-19
# couplings below this share of the largest are rounding noise to a count
NOISE_FLOOR = 1e-6
CASES = {"lih": (2, 8, 20), "h2o": (3, 20, 80)}


@pytest.fixture(scope="module", params=sorted(CASES))
def state(request):
    """A partially converged SCI state of each package's Hamiltonian."""
    name = request.param
    rounds, per_round, cap = CASES[name]
    jh = jmol.MOLECULE_FACTORIES[name]()
    h = pmol.MOLECULE_FACTORIES[name]("cpu")
    cfg = pre.ResidualExpansionConfig(max_iterations=rounds,
                                      configs_per_iteration=per_round,
                                      max_basis_size=cap)
    out = pre.iterative_residual_expansion(h, h.get_hf_state()[None, :], cfg)
    basis = out["basis"]
    vals, vecs = h.exact_ground_state(basis, k=1)
    return jh, h, basis, vecs[:, 0], float(vals[0])


def test_host_closure_matches_jax_host(state):
    jh, h, basis, coeffs, e = state
    got = pre.SelectedCIExpander(h)._pt2_correction_host(basis, coeffs, e)
    jhost = jre.SelectedCIExpander(jh)
    jhost._pt2_row_cap = 0                    # the JAX host-f64 path
    want = jhost.pt2_correction(basis, coeffs, e)
    assert abs(got["de2"] - want["de2"]) < HOST_TOL
    assert got["n_external"] == want["n_external"]
    assert got["exact"] and got["de2"] < 0
    assert got["corrected_energy"] == e + got["de2"]


def _host_couplings(h, basis, coeffs):
    """Every external key of ``basis`` with a nonzero f64 coupling (the
    host closure's externals), its coupling and the sum of its terms'
    magnitudes."""
    conn, elems = h.connections_np(basis)
    keys = h.keys(conn.reshape(-1, conn.shape[-1]))
    contrib = (elems * coeffs[:, None]).reshape(-1)
    uniq, inverse = np.unique(keys, return_inverse=True)
    coupling = np.bincount(inverse, weights=contrib, minlength=len(uniq))
    scale = np.bincount(inverse, weights=np.abs(contrib),
                        minlength=len(uniq))
    ext = ~np.isin(uniq, h.keys(basis)) & (coupling != 0.0)
    return uniq[ext], coupling[ext], scale[ext]


def _device_external_keys(exp, basis, coeffs):
    h = exp.h
    basis_keys = torch.sort(h.keys_device(to_device(basis, h.device)))[0]
    key, _, score, _ = exp._pt2_correction_block(basis, coeffs, basis_keys,
                                                 1 << 23)
    return h.keys_to_host(key[score > 0])


def test_device_block_matches_host_and_jax_device(state):
    jh, h, basis, coeffs, e = state
    exp = pre.SelectedCIExpander(h)
    dev = exp.pt2_correction(basis, coeffs, e)
    host = exp._pt2_correction_host(basis, coeffs, e)
    jdev = jre.SelectedCIExpander(jh).pt2_correction(basis, coeffs, e)
    assert dev["exact"] and jdev["exact"]
    assert abs(dev["de2"] - host["de2"]) < DEVICE_TOL
    assert abs(dev["de2"] - jdev["de2"]) < DEVICE_TOL
    # the externality mask, key by key against the host's
    keys, coupling, scale = _host_couplings(h, basis, coeffs)
    assert len(keys) == host["n_external"]
    dev_keys = _device_external_keys(exp, basis, coeffs)
    assert len(dev_keys) == dev["n_external"]
    assert np.isin(dev_keys, keys).all()
    missing = ~np.isin(keys, dev_keys)
    assert missing.sum() <= 1e-3 * host["n_external"]
    floor = np.maximum(CANCEL_RTOL * scale, SQUARE_UNDERFLOW)
    assert (np.abs(coupling[missing]) <= floor[missing]).all()
    resolved = int((np.abs(coupling) > floor).sum())
    assert 0 < resolved <= jdev["n_external"] <= host["n_external"]
    assert resolved <= dev["n_external"]
    # closer to FCI than the variational energy
    assert abs(dev["corrected_energy"] - h.fci_energy()) < 0.5 * (
        e - h.fci_energy())


def test_row_budget_zero_takes_the_host_path(state):
    _, h, basis, coeffs, e = state
    exp = pre.SelectedCIExpander(h)
    exp._pt2_row_cap = 0
    assert exp.pt2_correction(basis, coeffs, e) == \
        exp._pt2_correction_host(basis, coeffs, e)


def test_cap_below_the_externals_is_not_exact(state):
    _, h, basis, coeffs, e = state
    exp = pre.SelectedCIExpander(h)
    full = exp.pt2_correction(basis, coeffs, e)
    cut = exp.pt2_correction(basis, coeffs, e, cap=10)
    assert full["exact"] and not cut["exact"]
    assert cut["n_external"] == 10 < full["n_external"]
    # the rows kept are the ten largest couplings: part of the weight
    assert full["de2"] < cut["de2"] < 0


def test_two_calls_agree_bit_for_bit(state):
    _, h, basis, coeffs, e = state
    a = pre.SelectedCIExpander(h).pt2_correction(basis, coeffs, e)
    b = pre.SelectedCIExpander(h).pt2_correction(basis, coeffs, e,
                                                 pad_to=4096)
    assert a == b


def test_blocked_equals_one_block():
    """A basis above half the scoring row budget goes through in source
    blocks, whose partial couplings add up on the host: dE2 equals the
    one-block sum to 1e-9 (f32 couplings summed in f64 in another
    grouping) and the host's to 1e-6."""
    h = pmol.create_lih_hamiltonian("cpu")
    sub = h.enumerate_basis()[:112]
    vals, vecs = h.exact_ground_state(sub, k=1)
    e, coeffs = float(vals[0]), vecs[:, 0]
    one = pre.SelectedCIExpander(h).pt2_correction(sub, coeffs, e)
    blk = pre.SelectedCIExpander(h)
    blk._pt2_row_cap = 128                    # blocks of 64 rows: 2 blocks
    two = blk.pt2_correction(sub, coeffs, e)
    host = blk._pt2_correction_host(sub, coeffs, e)
    assert one["exact"] and two["exact"]
    assert abs(two["de2"] - one["de2"]) < 1e-7
    assert abs(two["de2"] - host["de2"]) < DEVICE_TOL
    assert two["corrected_energy"] <= e + 1e-12


def test_multiword_raises_naming_its_queue():
    """The multiword dE2 is ported (``tests/test_torch_multiword.py``), and
    so, since restricted SKQD over 4-word determinants took its device
    ELL build on key pairs, is SKQD within a subspace of 4-word
    determinants (33 orbitals): it builds, and its one-state evolve is
    the identity up to a phase."""
    from flow_guided_krylov_torch.krylov.skqd import \
        SampleBasedKrylovDiagonalization
    h = pmol.create_synthetic_hamiltonian(33, 1, 1, "cpu")
    assert h.pack_words == 4
    hf = h.get_hf_state()[None, :]
    s = SampleBasedKrylovDiagonalization(h, subspace_states=hf)
    assert s.dim == 1
    assert abs(abs(s.evolve(np.ones(1, complex))[0]) - 1.0) < 1e-12


def test_iterative_expansion_pt2_keys_match_jax():
    jh = jmol.create_lih_hamiltonian()
    h = pmol.create_lih_hamiltonian("cpu")
    kw = dict(max_iterations=3, configs_per_iteration=8, max_basis_size=40)
    out = pre.iterative_residual_expansion(
        h, h.get_hf_state()[None, :], pre.ResidualExpansionConfig(**kw),
        pt2_correct=True, pt2_checkpoints=[9, 17])
    want = jre.iterative_residual_expansion(
        jh, jh.get_hf_state()[None, :], jre.ResidualExpansionConfig(**kw),
        pt2_correct=True, pt2_checkpoints=[9, 17])
    assert set(out) == set(want)
    np.testing.assert_array_equal(out["basis"], want["basis"])
    assert abs(out["pt2_de2"] - want["pt2_de2"]) < DEVICE_TOL
    # the external counts, through couplings that no float32 sum can
    # cancel to 0.0: every key above the noise floor (a millionth of the
    # largest coupling, or its own terms' float32 resolution) is counted by
    # both packages, and neither counts a key no connection reaches
    basis = out["basis"]
    keys, coupling, scale = _host_couplings(
        h, basis, h.exact_ground_state(basis, k=1)[1][:, 0])
    floor = np.maximum(np.maximum(NOISE_FLOOR * np.abs(coupling).max(),
                                  CANCEL_RTOL * scale), SQUARE_UNDERFLOW)
    significant = int((np.abs(coupling) > floor).sum())
    conn, _ = h.connections_np(basis)
    reached = np.unique(h.keys(conn.reshape(-1, conn.shape[-1])))
    reached = int((~np.isin(reached, h.keys(basis))).sum())
    assert out["pt2_exact"] and want["pt2_exact"]
    assert 0 < significant <= out["pt2_n_external"] <= reached
    assert significant <= want["pt2_n_external"] <= reached
    assert abs(out["pt2_corrected_energy"]
               - (out["energy"] + out["pt2_de2"])) < 1e-12
    assert [r["basis_size"] for r in out["pt2_checkpoints"]] == \
        [r["basis_size"] for r in want["pt2_checkpoints"]]
    for r, w in zip(out["pt2_checkpoints"], want["pt2_checkpoints"]):
        assert set(r) == set(w)
        assert abs(r["de2"] - w["de2"]) < DEVICE_TOL
        assert abs(r["e_var"] - w["e_var"]) < 1e-10
