"""Port parity: molecular determinants past 32 orbitals (two words per
spin channel, 4-word rows ``[a_hi, a_lo, b_hi, b_lo]``) against the JAX
package on the CPU.

The shapes and seeds are those of the JAX package's
``tests/test_molecular_w2.py``.  Held to:

* the two-word bit primitives, ``KEY128`` keys and the w2 connection
  targets: bit-identical (the primitives also at bits 0, 31, 32 and 63);
* host w2 elements: 1e-12 (the same f64 NumPy); device elements:
  ``DEVICE_ELEM_TOL`` against the host f64 mirror and against the JAX
  device kernel (float32 sums of a few integrals in another order);
* Selected-CI on a 6-orbital system embedded in 34 orbitals: the same
  energies and bases round for round, with host and with forced device
  scoring;
* the multiword exact dE2 (device blocks, host merge, f64 device
  denominators) against the host f64 path: ``DE2_TOL``.
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.chem.scf import MolecularIntegrals as JInts
from flow_guided_krylov_tpu.hamiltonians.molecular import \
    MolecularHamiltonian as JMol
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_tpu.ops import bits as jbits
from flow_guided_krylov_torch.chem.scf import MolecularIntegrals as PInts
from flow_guided_krylov_torch.hamiltonians.base import lex_order
from flow_guided_krylov_torch.hamiltonians.molecular import \
    MolecularHamiltonian as PMol
from flow_guided_krylov_torch.krylov import residual_expansion as pre
from flow_guided_krylov_torch.ops import bits as pbits
from flow_guided_krylov_torch.ops.bits import to_device, to_host

torch.set_num_threads(1)

HOST_ELEM_TOL = 1e-12
DEVICE_ELEM_TOL = 2e-5      # float32 elements, |h| ~ 1
DE2_TOL = 1e-8


def _random_ints(n, n_alpha, n_beta, seed=0):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(n, n))
    h1 = 0.5 * (h1 + h1.T)
    h2 = rng.normal(size=(n,) * 4) * 0.1
    h2 = h2 + h2.transpose(1, 0, 2, 3)
    h2 = h2 + h2.transpose(0, 1, 3, 2)
    h2 = h2 + h2.transpose(2, 3, 0, 1)
    return dict(h1e=h1, h2e=h2 / 8, nuclear_repulsion=0.5,
                n_electrons=n_alpha + n_beta, n_orbitals=n,
                n_alpha=n_alpha, n_beta=n_beta)


def _embed(ints, n_big):
    n = ints["n_orbitals"]
    h1 = np.zeros((n_big, n_big))
    h1[:n, :n] = ints["h1e"]
    h2 = np.zeros((n_big,) * 4)
    h2[:n, :n, :n, :n] = ints["h2e"]
    return dict(ints, h1e=h1, h2e=h2, n_orbitals=n_big)


def _pair(ints):
    """(JAX Hamiltonian, port Hamiltonian on the CPU) of one integral set."""
    return JMol(JInts(**ints)), PMol(PInts(**ints), "cpu")


def _widen(packed2):
    """(B, 2) single-word rows -> (B, 4) two-word rows (hi words zero)."""
    z = np.zeros(len(packed2), np.uint32)
    return np.stack([z, packed2[:, 0], z, packed2[:, 1]], -1)


def _channels(vals):
    return np.stack([np.array([v >> 32 for v in vals], np.uint32),
                     np.array([v & 0xFFFFFFFF for v in vals], np.uint32)], -1)


# ---------------------------------------------------------------------------
# Two-word primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [61, 64])
def test_two_word_primitives_match_jax_and_python_ints(n):
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    B = 64
    vals = [int(rng.integers(0, 1 << 62)) << (n - 62) if n > 62
            else int(rng.integers(0, 1 << n)) for _ in range(B)]
    vals[:2] = [(1 << n) - 1, (1 << 63) | 1 if n == 64 else 1 << 32]
    vals = [v | int(rng.integers(0, 4)) for v in vals]
    bits2 = _channels(vals)
    p = rng.integers(0, n, B).astype(np.int32)
    q = rng.integers(0, n, B).astype(np.int32)
    edges = [0, 31, 32, n - 1]                 # bits 0, 31, 32 and 63
    p[:8] = edges + edges
    q[:8] = edges[::-1] + [31, 0, n - 1, 32]
    pt, qt = torch.as_tensor(p, dtype=torch.int64), \
        torch.as_tensor(q, dtype=torch.int64)
    dev = to_device(bits2, "cpu")

    occ = [pbits.occupancy2_np(bits2, n), pbits.occupancy2(dev, n).numpy(),
           np.asarray(jbits.occupancy2(jnp.asarray(bits2), n))]
    par = [pbits.parity_between2_np(bits2, p, q),
           pbits.parity_between2(dev, pt, qt).numpy(),
           np.asarray(jbits.parity_between2(jnp.asarray(bits2),
                                            jnp.asarray(p), jnp.asarray(q)))]
    flip = [pbits.flip_orbital2_np(bits2, p),
            to_host(pbits.flip_orbital2(dev, pt)),
            np.asarray(jbits.flip_orbital2(jnp.asarray(bits2),
                                           jnp.asarray(p)))]
    for i, v in enumerate(vals):
        lo, hi = sorted((int(p[i]), int(q[i])))
        sign = 1 - 2 * (sum((v >> j) & 1 for j in range(lo + 1, hi)) & 1)
        for o in occ:
            assert list(o[i]) == [(v >> j) & 1 for j in range(n)]
        for s in par:
            assert s[i] == sign
        for f in flip:
            assert (int(f[i, 0]) << 32) | int(f[i, 1]) == v ^ (1 << int(p[i]))
    occ_pack = pbits.occupancy2_np(bits2, n)
    assert np.array_equal(pbits.pack2_np(occ_pack), jbits.pack2_np(occ_pack))
    assert np.array_equal(pbits.pack2_np(occ_pack), bits2)


def test_key128_matches_jax_roundtrips_and_orders():
    jh, h = _pair(_random_ints(34, 2, 2))
    assert h.pack_words == 4 and h.KEY128 == jh.KEY128
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 1 << 32, size=(256, 4)).astype(np.uint32)
    rows[:, 0] &= 0x3
    rows[:, 2] &= 0x3
    rows[128:160] = rows[:32]                 # duplicates: stable order
    rows[200, 0] = 0xFFFFFFFF                 # top bit of a channel
    keys = h.keys(rows)
    assert keys.tobytes() == jh.keys(rows).tobytes()
    assert np.array_equal(h.unkey(keys), rows)
    nums = [((int(r[0]) << 32 | int(r[1])), (int(r[2]) << 32 | int(r[3])))
            for r in rows]
    order = np.argsort(keys, kind="stable")
    assert [nums[i] for i in order] == sorted(nums)
    # device key pairs: back to the same KEY128, and two stable sorts give
    # the records' stable order
    kd = h.keys_device(to_device(rows, "cpu"))
    assert kd.shape == (256, 2)
    assert h.keys_to_host(kd).tobytes() == keys.tobytes()
    assert np.array_equal(lex_order(kd).numpy(), order)
    uniq, first, inv = pre._sorted_unique(keys, return_inverse=True)
    juniq, jfirst, jinv = jre._sorted_unique(keys, return_inverse=True)
    assert uniq.tobytes() == juniq.tobytes()
    assert np.array_equal(first, jfirst) and np.array_equal(inv, jinv)


# ---------------------------------------------------------------------------
# Connections, diagonal, HF
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w2_35():
    """The JAX test's 35-orbital system and its HF + 40 live targets."""
    jh, h = _pair(_random_ints(35, 2, 2, seed=3))
    hf = jh.get_hf_state()[None, :]
    conn, el = jh.connections_np(hf)
    live = conn[0][np.abs(el[0]) > 1e-10][:40]
    return jh, h, np.concatenate([hf, live], axis=0).astype(np.uint32)


def test_w2_host_connections_match_jax(w2_35):
    jh, h, batch = w2_35
    assert np.array_equal(h.get_hf_state(), jh.get_hf_state())
    c_j, e_j = jh.connections_np(batch)
    c_p, e_p = h.connections_np(batch)
    assert c_p.shape == (len(batch), h.n_connections, 4)
    assert np.array_equal(c_p, c_j)
    assert np.max(np.abs(e_p - e_j)) <= HOST_ELEM_TOL
    assert np.max(np.abs(h.diagonal_np(batch) - jh.diagonal_np(batch))) \
        <= HOST_ELEM_TOL


def test_w2_device_connections_match_jax(w2_35):
    import jax.numpy as jnp
    jh, h, batch = w2_35
    c_np, e_np = h.connections_np(batch)
    c_d, e_d = h.connections_device(to_device(batch, "cpu"))
    c_j, e_j = jh.connections_device(jnp.asarray(batch))
    assert np.array_equal(to_host(c_d), c_np)
    assert np.array_equal(to_host(c_d), np.asarray(c_j))
    assert np.max(np.abs(e_d.numpy() - e_np)) < DEVICE_ELEM_TOL
    assert np.max(np.abs(e_d.numpy() - np.asarray(e_j))) < DEVICE_ELEM_TOL
    d_np = h.diagonal_np(batch)
    rows = to_device(batch, "cpu")
    assert np.max(np.abs(h.diagonal_device(rows).numpy() - d_np)
                  / (1.0 + np.abs(d_np))) < 1e-5
    assert np.max(np.abs(h.diagonal_device(rows, dtype=torch.float64
                                           ).numpy() - d_np)) < 1e-12


def test_w2_hf_state_spans_words():
    jh, h = _pair(_random_ints(34, 33, 2, seed=4))
    hf = h.get_hf_state()
    assert np.array_equal(hf, jh.get_hf_state())
    assert (int(hf[0]) << 32) | int(hf[1]) == (1 << 33) - 1
    assert (int(hf[2]) << 32) | int(hf[3]) == 3


def test_embedding_34_matches_6_orbital_kernel():
    small_ints = _random_ints(6, 2, 2)
    small = PMol(PInts(**small_ints), "cpu")
    big = PMol(PInts(**_embed(small_ints, 34)), "cpu")
    rng = np.random.default_rng(1)
    basis = small.enumerate_basis()
    sel = basis[rng.choice(len(basis), size=48, replace=False)]
    wide = _widen(sel)
    assert np.max(np.abs(small.matrix_elements(sel, sel)
                         - big.matrix_elements(wide, wide))) < 1e-12
    assert np.max(np.abs(big.diagonal_np(wide) - small.diagonal_np(sel))) \
        < 1e-12
    # the sparse build (native connection hits on 64-bit channels and
    # 128-bit keys) equals the dense one
    assert np.max(np.abs(big.to_sparse(wide).toarray()
                         - big.matrix_elements(wide, wide))) < 1e-12


# ---------------------------------------------------------------------------
# Selected-CI and exact dE2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("force_device", [False, True],
                         ids=["host-scoring", "device-scoring"])
def test_w2_sci_trajectory_matches_jax(force_device):
    """HF-seeded Selected-CI on a 6-orbital system embedded in 34
    orbitals, one expander a package, round for round."""
    small_ints = _random_ints(6, 2, 2, seed=7)
    jh, h = _pair(_embed(small_ints, 34))
    kw = dict(max_iterations=30, configs_per_iteration=40,
              stagnation_threshold=1e-10, stagnation_patience=3,
              max_basis_size=240)
    jexp = jre.SelectedCIExpander(jh, jre.ResidualExpansionConfig(**kw),
                                  use_device_scoring=force_device)
    pexp = pre.SelectedCIExpander(h, pre.ResidualExpansionConfig(**kw),
                                  use_device_scoring=force_device)
    jb = pb = h.get_hf_state()[None, :]
    for _ in range(4):
        jo, po = jexp.expand_basis(jb), pexp.expand_basis(pb)
        jb, pb = jo["basis"], po["basis"]
        assert np.array_equal(pb, jb)
        assert po["energy"] == pytest.approx(jo["energy"], abs=1e-10)
    pops = [bin((int(r[0]) << 32) | int(r[1])).count("1") for r in pb]
    assert set(pops) == {2}


def test_w2_expansion_reaches_embedded_fci_with_de2(tmp_path, monkeypatch):
    """The JAX package's end-to-end w2 test on the port: every excitation
    into the 28 zero-coupling virtuals scores zero, so Selected-CI reaches
    the small system's FCI energy, and its dE2 there is tiny and not
    positive (round-for-round parity: the trajectory tests above)."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    small_ints = _random_ints(6, 2, 2, seed=7)
    h = PMol(PInts(**_embed(small_ints, 34)), "cpu")
    e_fci = PMol(PInts(**small_ints), "cpu").fci_energy()
    kw = dict(max_iterations=30, configs_per_iteration=40,
              stagnation_threshold=1e-10, stagnation_patience=3,
              max_basis_size=240)
    po = pre.iterative_residual_expansion(
        h, h.get_hf_state()[None, :], pre.ResidualExpansionConfig(**kw),
        pt2_correct=True)
    assert po["energy"] >= e_fci - 1e-9
    assert abs(po["energy"] - e_fci) < 2e-4
    assert po["pt2_de2"] <= 1e-12 and po["pt2_exact"]
    assert abs(po["pt2_de2"]) < 1e-3


def test_w2_multiword_de2_matches_host():
    small_ints = _random_ints(6, 2, 2, seed=11)
    jh, h = _pair(_embed(small_ints, 34))
    cfg = pre.ResidualExpansionConfig(max_iterations=3,
                                      configs_per_iteration=30,
                                      max_basis_size=100)
    exp = pre.SelectedCIExpander(h, cfg)
    basis = h.get_hf_state()[None, :]
    for _ in range(2):
        basis = exp.expand_basis(basis)["basis"]
    e, coeffs = exp._diagonalize(basis)
    host = exp._pt2_correction_host(basis, coeffs, e)
    dev = exp.pt2_correction(basis, coeffs, e)        # routes to multiword
    jexp = jre.SelectedCIExpander(jh, jre.ResidualExpansionConfig(
        max_iterations=3, configs_per_iteration=30, max_basis_size=100))
    jexp._pt2_row_cap = 0                             # the JAX host path
    jhost = jexp.pt2_correction(basis, coeffs, e)
    assert dev["exact"] and host["exact"]
    assert dev["n_external"] == host["n_external"] == jhost["n_external"]
    assert abs(dev["de2"] - host["de2"]) < DE2_TOL
    assert abs(host["de2"] - jhost["de2"]) < DE2_TOL
    # small blocks: the host merge sums the partial couplings of a key
    exp._pt2_row_cap = 16
    blk = exp._pt2_correction_multiword(basis, coeffs, e, cap=1 << 20)
    assert blk["exact"] and blk["n_external"] == host["n_external"]
    assert abs(blk["de2"] - host["de2"]) < DE2_TOL
    # a window smaller than the weighted rows is reported as not exact
    assert not exp._pt2_correction_multiword(basis, coeffs, e,
                                             cap=10)["exact"]


# ---------------------------------------------------------------------------
# What the JAX package cannot run raises by name
# ---------------------------------------------------------------------------

def test_unported_multiword_molecular_paths_raise():
    """The pipeline over 4-word determinants still raises (the JAX
    package's own pipeline fails there); restricted SKQD and the
    connection table at W = 4 are ported (``tests/test_torch_skqd_w4.py``):
    SKQD builds over the restricted states, and the table is None, as in
    the JAX package."""
    from flow_guided_krylov_torch.krylov.skqd import (
        SampleBasedKrylovDiagonalization, build_restricted_subspace)
    from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                                   PipelineConfig)
    from flow_guided_krylov_torch.utils.connection_table import \
        build_connection_table
    h = PMol(PInts(**_embed(_random_ints(6, 2, 2, seed=7), 34)), "cpu")
    hf = h.get_hf_state()[None, :]
    with pytest.raises(NotImplementedError, match="item 2 remainder"):
        FlowGuidedKrylovPipeline(h, PipelineConfig())
    states = build_restricted_subspace(h, hf, cap=50)
    assert len(states) == 50
    skqd = SampleBasedKrylovDiagonalization(h, subspace_states=states)
    assert skqd.dim == 50 and skqd._index_of(hf)[0] == 0
    assert build_connection_table(h) is None
