"""Port parity: the multi-device layer (``flow_guided_krylov_torch/
parallel/`` and the ``mesh=`` arms) on an 8-entry ``cpu`` mesh, held to
the port without a mesh and to the JAX package on its 8 virtual CPU
devices (``tests/conftest.py``).

Mirrors ``tests/test_parallel.py`` and the three mesh tests of
``tests/test_residual_expansion.py``.  Held to:

* mesh shapes: the JAX package's (8 -> 4 x 2, 1 -> 1 x 1, ...);
* the ELL-sharded product, evolve and oracle: bit-equal to the port
  without a mesh (the row-block form sums each row in the square
  product's order); the sharded Trotter substep: the single-device bits,
  and ``TROTTER_TOL`` of the JAX package's sharded substep;
* the dense-sharded propagator: ``EVOLVE_TOL`` of scipy's f64 propagator
  and of the JAX package's sharded one;
* Selected-CI trajectories with the mesh: equal to those without, and to
  the JAX package's with its mesh; the exact dE2 with the mesh:
  ``DE2_TOL`` of the one without (4-word determinants included: the JAX
  package's multiword mesh branch is broken, so the port's sharded sum is
  held to its own single-device one);
* one stage-1 step with the mesh: ``STEP_TOL`` of the step without;
* the LiH-sized pipeline and ``dryrun_multichip(8, device="cpu")``:
  within 1e-4 Ha of the run without a mesh.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_tpu.krylov import skqd as jsk
from flow_guided_krylov_tpu.parallel import make_mesh as jmake_mesh
from flow_guided_krylov_tpu.parallel import sharded_matvec as jsm
from flow_guided_krylov_tpu.parallel import sharded_trotter as jst
from flow_guided_krylov_torch import parallel as par
from flow_guided_krylov_torch.flows import particle_conserving as ppc
from flow_guided_krylov_torch.flows import physics_guided_training as ppg
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.hamiltonians import spin as pspin
from flow_guided_krylov_torch.krylov import residual_expansion as pre
from flow_guided_krylov_torch.krylov import skqd as psk
from flow_guided_krylov_torch.models import dense as pdense
from flow_guided_krylov_torch.ops.ell_spmv import (ell_spmv,
                                                   ell_spmv_reference)
from flow_guided_krylov_torch.ops.x_sweep import _pauli_masks

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_multiword import _embed, _pair, _random_ints  # noqa: E402

torch.set_num_threads(1)

EVOLVE_TOL = 1e-5        # float32 propagators against f64 / each other
TROTTER_TOL = 1e-5       # float32 substeps, the words in one order
STEP_TOL = 2e-5          # float32 metrics and parameters of one step
DE2_TOL = 1e-8           # host f64 merges of float32 / float64 couplings
PIPE_TOL = 1e-4          # the JAX dryrun's pipeline parity line


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8, devices=jax.devices("cpu"), basis_parallel=2)


@pytest.fixture(scope="module")
def lih():
    jh = jmol.create_lih_hamiltonian()
    return jh, pmol.MolecularHamiltonian(jh.integrals, "cpu")


def _seed_basis(h, n=40):
    basis = h.enumerate_basis()
    return basis[np.argsort(h.diagonal_np(basis))[:n]]


def test_mesh_shapes():
    devs = jax.devices("cpu")
    for n in (1, 2, 3, 4, 6, 8):
        got = par.make_mesh(n, devices=["cpu"] * n)
        assert got.shape == dict(jmake_mesh(n, devices=devs).shape)
        assert got.size == n and got.n_physical == 1
    assert par.make_mesh(8, devices=["cpu"] * 8).shape == {"data": 4,
                                                           "basis": 2}
    assert par.make_mesh(1, devices=["cpu"]).shape == {"data": 1, "basis": 1}
    with pytest.raises(ValueError, match="divisible"):
        par.make_mesh(6, basis_parallel=4, devices=["cpu"] * 6)


def test_make_mesh_raises_beyond_the_host_cards():
    """No shrinking: a CUDA mesh wider than the host's cards raises."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="cards"):
        par.make_mesh(have + 1)
    with pytest.raises(RuntimeError, match="not a device"):
        par.make_mesh(2, devices=[f"cuda:{have}"] * 2)


def test_row_blocks_equal_the_square_product():
    """The row-block plain version: blocks concatenated = the square
    product, bit for bit, at several cuts (the segments are N's)."""
    g = torch.Generator().manual_seed(0)
    n, c = 333, 40
    d = torch.randn(n, generator=g)
    e = torch.randn(c, n, generator=g)
    t = torch.randint(0, n, (c, n), generator=g, dtype=torch.int32)
    psi = torch.randn(2, n, generator=g)
    full = ell_spmv(d, e, t, psi)
    for cuts in ((0, 100, 333), (0, 1, 2, 333), (0, 167, 200, 333)):
        parts = [ell_spmv_reference(d[a:b], e[:, a:b].contiguous(),
                                    t[:, a:b].contiguous(), psi, a)
                 for a, b in zip(cuts[:-1], cuts[1:])]
        assert torch.equal(torch.cat(parts, -1), full)
    with pytest.raises(ValueError, match="leave"):
        ell_spmv_reference(d[:10], e[:, :10], t[:, :10], psi, 330)


def test_sharded_lanczos_matches_host_and_jax(lih, mesh, jmesh):
    jh, ph = lih
    basis = ph.enumerate_basis()
    H = ph.to_sparse(basis).toarray()
    hs = par.shard_hamiltonian_rows(mesh, H.astype(np.float32))
    assert len(hs.blocks) == 8 and hs.blocks[0].shape == (29, 225)
    e, v = par.sharded_lanczos_ground_state(mesh, hs, m=80)
    assert e == pytest.approx(np.linalg.eigh(H)[0][0], abs=5e-4)
    psi0 = np.zeros(225, np.float32)
    psi0[psk.SampleBasedKrylovDiagonalization(ph)._index_of(
        ph.get_hf_state())[0]] = 1.0
    re, im = par.sharded_lanczos_expm(mesh, hs, torch.as_tensor(psi0),
                                      torch.zeros(225), 0.1, 30)
    out = re.numpy() + 1j * im.numpy()
    import scipy.sparse.linalg as spla
    ref = spla.expm_multiply(-1j * 0.1 * ph.to_sparse(basis),
                             psi0.astype(complex))
    assert np.abs(out - ref).max() < EVOLVE_TOL
    # the JAX package's sharded propagator on its padded H
    Hp = np.zeros((232, 232), np.float32)
    Hp[:225, :225] = H
    jr, ji = jsm.sharded_lanczos_expm(
        jmesh, jsm.shard_hamiltonian_rows(jmesh, jnp.asarray(Hp)),
        jnp.asarray(np.pad(psi0, (0, 7))), jnp.zeros(232, jnp.float32),
        0.1, 30)
    jout = np.asarray(jr)[:225] + 1j * np.asarray(ji)[:225]
    assert np.abs(out - jout).max() < EVOLVE_TOL


def test_skqd_sharded_dense_evolution(lih, mesh, jmesh):
    jh, ph = lih
    one = psk.SampleBasedKrylovDiagonalization(
        ph, psk.SKQDConfig(evolution="dense"))
    sk = psk.SampleBasedKrylovDiagonalization(
        ph, psk.SKQDConfig(evolution="dense"), mesh=mesh)
    # a logical mesh (one physical device) raises no budget
    assert sk._dense_evolution_cap() == one._dense_evolution_cap()
    assert (psk.supported_evolution_dim(ph, mesh)
            == psk.supported_evolution_dim(ph))
    psi = np.zeros(sk.dim, complex)
    psi[sk._index_of(ph.get_hf_state())[0]] = 1.0
    out = sk.evolve(psi)
    assert out.shape == (225,)
    assert np.abs(out - sk._evolve_scipy(psi)).max() < EVOLVE_TOL
    js = jsk.SampleBasedKrylovDiagonalization(
        jh, jsk.SKQDConfig(evolution="dense"), mesh=jmesh)
    assert np.abs(out - js.evolve(psi)).max() < EVOLVE_TOL


def test_sharded_ell_evolution_is_bit_equal(mesh):
    """Heisenberg-12's S_z = 0 sector (924 states, 928 padded): the
    row-sharded ELL evolve and the device oracle equal the unsharded
    ones bit for bit, and the evolve meets scipy."""
    hz = np.array([0.1] + [0.0] * 11)
    h = pspin.HeisenbergHamiltonian(12, 1.0, 1.0, 1.0, h_z=hz, device="cpu")
    neel = np.array([sum(1 << i for i in range(0, 12, 2))], np.uint32)
    cfg = psk.SKQDConfig(evolution="ell")
    one = psk.SampleBasedKrylovDiagonalization(h, cfg, initial_state=neel)
    sk = psk.SampleBasedKrylovDiagonalization(h, cfg, initial_state=neel,
                                              mesh=mesh)
    assert sk.dim == 924
    psi = np.zeros(sk.dim, complex)
    psi[sk._index_of(neel)[0]] = 1.0
    out = sk.evolve(psi)
    assert np.array_equal(out, one.evolve(psi))
    assert np.abs(out - sk._evolve_scipy(psi)).max() < EVOLVE_TOL
    assert isinstance(sk._ell, par.ShardedEll)
    assert sk._ell.pad == (-924) % 8 and len(sk._ell.blocks) == 8
    assert (sk.exact_subspace_energy(refine_host=False)
            == one.exact_subspace_energy(refine_host=False))


def test_sharded_ell_blocks_are_built_in_place(lih, mesh):
    """LiH's full space (225 states, 232 padded) with the mesh takes the
    device build block by block: each block equals the column slice of
    the unsharded tables (from the connection table), its padding rows
    are zero, and the evolve is bit-equal."""
    _, h = lih
    cfg = psk.SKQDConfig(evolution="ell")
    one = psk.SampleBasedKrylovDiagonalization(h, cfg)
    sk = psk.SampleBasedKrylovDiagonalization(h, cfg, mesh=mesh)
    psi = np.zeros(sk.dim, complex)
    psi[sk._index_of(h.get_hf_state())[0]] = 1.0
    assert np.array_equal(sk.evolve(psi), one.evolve(psi))
    d, e, t = one._ell
    assert sk._ell.pad == 7 and len(sk._ell.blocks) == 8
    for row0, bd, be, bt in sk._ell.blocks:
        r = min(225, row0 + bd.shape[0]) - row0
        assert torch.equal(bd[:r], d[row0:row0 + r])
        assert torch.equal(be[:, :r], e[:, row0:row0 + r])
        assert torch.equal(bt[:, :r], t[:, row0:row0 + r])
        assert not (bd[r:].any() or be[:, r:].any() or bt[:, r:].any())


@pytest.mark.parametrize("kind", ["molecular", "spin"])
def test_hamiltonian_replica_starts_its_device_caches_empty(lih, kind):
    """``Hamiltonian.on``: itself on its own device; on another device a
    kept copy whose every ``DEVICE_CACHES`` entry holds its empty value
    while the original keeps its own."""
    h = (lih[1] if kind == "molecular"
         else pspin.HeisenbergHamiltonian(8, 1.0, 1.0, 1.0, device="cpu"))
    assert callable(h.connections_device)       # builds h's closures
    assert h.on("cpu") is h
    other = torch.device("meta")
    r = h.on(other)
    assert r is h.on(other) and r is not h and r.device == other
    assert h.DEVICE_CACHES
    for attr, empty in h.DEVICE_CACHES.items():
        assert getattr(r, attr) == empty
    assert any(getattr(h, a) is not None and getattr(h, a) is not False
               for a in h.DEVICE_CACHES)


def _tfim_terms(h):
    coeffs, words = jspin.extract_coeffs_and_paulis(h)
    masks = [_pauli_masks(w) for w in words]
    diag = [(c, zm) for c, (xm, zm, _) in zip(coeffs, masks) if xm == 0]
    offd = [(c, xm, zm, ny) for c, (xm, zm, ny) in zip(coeffs, masks)
            if xm != 0]
    return diag, offd


def test_sharded_trotter_substep_matches_jax(mesh, jmesh):
    """TFIM-10 (periodic, h = 0.5) over 8 blocks of 2^7: the sharded
    substep against the JAX package's ``make_sharded_substep`` on the
    same word list, three substeps from a random state."""
    jh = jspin.TransverseFieldIsing(10, V=1.0, h=0.5, periodic=True)
    assert par.mesh_supports_statevector(mesh, 10)
    assert jst.mesh_supports_statevector(jmesh, 10)
    assert not par.mesh_supports_statevector(mesh, 9)
    diag, offd = _tfim_terms(jh)
    assert any(xm >> 7 for _, xm, _, _ in offd)      # cross-block words
    dt_sub = 0.1 / 4
    rng = np.random.default_rng(0)
    v = rng.normal(size=(2, 1024)).astype(np.float32)
    v /= np.linalg.norm(v)
    step, hr, hi = par.make_sharded_substep(mesh, 10, diag, offd, dt_sub)
    re, im = par.shard_statevector(mesh, torch.as_tensor(v[0]),
                                   torch.as_tensor(v[1]))
    jstep, jhr, jhi = jst.make_sharded_substep(jmesh, 10, diag, offd, dt_sub)
    jre_, jim = jst.shard_statevector(jmesh, jnp.asarray(v[0]),
                                      jnp.asarray(v[1]))
    for _ in range(3):
        re, im = step(re, im, hr, hi)
        jre_, jim = jstep(jre_, jim, jhr, jhi)
    r, i = par.gather_statevector(mesh, re, im)
    assert np.abs(r.numpy() - np.asarray(jre_)).max() < TROTTER_TOL
    assert np.abs(i.numpy() - np.asarray(jim)).max() < TROTTER_TOL


def test_sharded_trotter_skqd_equals_single_device(mesh, monkeypatch):
    """SKQD's Trotter path with the mesh: the same evolve bits and the
    same samples as without on the mesh's word list (TFIM-10, 8 blocks).
    The single card's own list, each commuting X once at full angle, is
    the same product in exact arithmetic: equal to float32 rounding."""
    h = pspin.TransverseFieldIsing(10, V=1.0, h=0.5, periodic=True,
                                   device="cpu")
    init = np.array([0], np.uint32)
    cfg = psk.SKQDConfig(evolution="trotter", max_krylov_dim=4,
                         shots_per_krylov=5000, num_trotter_steps=4, seed=7)
    own = psk.SampleBasedKrylovDiagonalization(h, cfg, initial_state=init)
    one = psk.SampleBasedKrylovDiagonalization(h, cfg, initial_state=init)
    sk = psk.SampleBasedKrylovDiagonalization(h, cfg, initial_state=init,
                                              mesh=mesh)
    assert sk.use_trotter and sk._sharded_statevector()
    re = torch.zeros(1024)
    re[0] = 1.0
    r0, i0 = own._evolve_trotter(re, torch.zeros(1024))
    monkeypatch.setattr(psk, "_substep_words", lambda offd, dt: (
        psk._half_angle_words(offd, dt), False))
    r1, i1 = one._evolve_trotter(re, torch.zeros(1024))
    rb, ib = sk._evolve_trotter(*par.shard_statevector(mesh, re,
                                                       torch.zeros(1024)))
    r2, i2 = par.gather_statevector(mesh, rb, ib)
    assert torch.equal(r1, r2) and torch.equal(i1, i2)
    a, b = one.run(), sk.run()
    assert a["samples"] == b["samples"]
    assert a["final_energy"] == b["final_energy"]
    np.testing.assert_allclose(r0.numpy(), r2.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(i0.numpy(), i2.numpy(), rtol=0, atol=1e-6)


def test_sharded_pt2_scoring_matches_single_device(lih, mesh):
    _, h = lih
    basis = _seed_basis(h, 60)
    vals, vecs = h.exact_ground_state(basis, k=1)
    e0, coeffs = float(vals[0]), vecs[:, 0]
    one = pre.SelectedCIExpander(h, use_device_scoring=True)
    sh = pre.SelectedCIExpander(h, use_device_scoring=True, mesh=mesh)
    cand_s, sc_s = one._pt2_candidates(basis, coeffs, e0)
    cand_m, sc_m = sh._pt2_candidates(basis, coeffs, e0)
    np.testing.assert_array_equal(h.keys(cand_s), h.keys(cand_m))
    np.testing.assert_allclose(sc_m, sc_s, rtol=1e-5, atol=1e-12)


def test_sharded_pt2_correction_matches_single_device(lih, mesh):
    _, h = lih
    sub = h.enumerate_basis()[:112]
    vals, vecs = h.exact_ground_state(sub, k=1)
    e_var, coeffs = float(vals[0]), vecs[:, 0]
    corr_m = pre.SelectedCIExpander(h, mesh=mesh).pt2_correction(
        sub, coeffs, e_var)
    corr_1 = pre.SelectedCIExpander(h).pt2_correction(sub, coeffs, e_var)
    host = pre.SelectedCIExpander(h)
    host._pt2_row_cap = 0
    corr_h = host.pt2_correction(sub, coeffs, e_var)
    assert corr_m["exact"] and corr_m["n_external"] == corr_1["n_external"]
    assert abs(corr_m["de2"] - corr_1["de2"]) < DE2_TOL
    assert abs(corr_m["de2"] - corr_h["de2"]) < DE2_TOL


def test_sharded_multiword_pt2_correction_matches_single_device(mesh):
    """4-word determinants: the sharded exact dE2 against the same sum on
    one device (the JAX mesh branch here is broken: ROADMAP.md,
    Queue 3)."""
    _, h = _pair(_embed(_random_ints(6, 2, 2, seed=7), 34))
    basis = h.unkey(np.sort(h.keys(
        pre.SelectedCIExpander(h).expand_basis(
            h.get_hf_state()[None, :])["basis"])))
    vals, vecs = h.exact_ground_state(basis, k=1)
    e, c = float(vals[0]), vecs[:, 0]
    one = pre.SelectedCIExpander(h).pt2_correction(basis, c, e)
    sh = pre.SelectedCIExpander(h, mesh=mesh).pt2_correction(basis, c, e)
    assert one["exact"] and sh["exact"]
    assert sh["n_external"] == one["n_external"]
    assert abs(sh["de2"] - one["de2"]) < DE2_TOL


def test_sharded_sci_trajectories_equal(lih, mesh, jmesh):
    """Selected-CI from a 20-state seed with forced device scoring: the
    same energies with the mesh as without; with host scoring (the
    default at this size) the same as the JAX package's with its mesh."""
    jh, h = lih
    cfg = pre.ResidualExpansionConfig(configs_per_iteration=40,
                                      max_iterations=4, max_basis_size=225)
    seed = _seed_basis(h, 20)
    ex1 = pre.SelectedCIExpander(h, cfg, use_device_scoring=True)
    exm = pre.SelectedCIExpander(h, cfg, use_device_scoring=True, mesh=mesh)
    b1 = bm = seed
    for _ in range(3):
        o1, om = ex1.expand_basis(b1), exm.expand_basis(bm)
        # the same determinants; the order of the added ones follows
        # scores that differ in their last bits
        np.testing.assert_array_equal(np.sort(h.keys(o1["basis"])),
                                      np.sort(h.keys(om["basis"])))
        assert abs(o1["energy"] - om["energy"]) < 1e-12
        b1, bm = o1["basis"], om["basis"]
    out = pre.iterative_residual_expansion(h, seed, cfg, mesh=mesh)
    jout = jre.iterative_residual_expansion(
        jh, seed, jre.ResidualExpansionConfig(
            configs_per_iteration=40, max_iterations=4, max_basis_size=225),
        mesh=jmesh)
    np.testing.assert_allclose(out["energies"], jout["energies"], rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("route,options", [
    ("dense", {}), ("table", {"dense_local_energy_max_dim": 0}),
    ("fly", {"use_connection_table": False})])
def test_sharded_training_step_matches_single_device(lih, mesh, route,
                                                     options):
    _, h = lih

    def run(m):
        tr = ppg.PhysicsGuidedFlowTrainer(
            h, ppc.ParticleConservingFlow(6, 2, 2, [32, 32]),
            pdense.DenseNQS(12, [32, 32]),
            ppg.PhysicsGuidedConfig(samples_per_batch=64, verbose=False,
                                    seed=11, **options), mesh=m)
        assert tr.route == route
        vec = tr.step(1.0)
        params = [p.detach() for p in list(tr.flow.parameters())
                  + list(tr.nqs.parameters())]
        return vec, params, tr.accumulated_basis

    v1, p1, acc1 = run(None)
    vm, pm, accm = run(mesh)
    assert torch.allclose(vm, v1, rtol=0, atol=STEP_TOL)
    assert vm[4] == v1[4]                    # the same samples' uniques
    np.testing.assert_array_equal(acc1, accm)
    for a, b in zip(p1, pm):
        assert torch.allclose(a, b, rtol=0, atol=STEP_TOL)


def test_pipeline_mesh_matches_single_device(lih):
    from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                                   PipelineConfig)
    _, h = lih
    exact = h.fci_energy()

    def run(n):
        cfg = PipelineConfig(max_epochs=25, min_epochs=8,
                             samples_per_batch=128, nf_hidden_dims=[32, 32],
                             nqs_hidden_dims=[32, 32], residual_iterations=2,
                             max_krylov_dim=3, shots_per_krylov=2000,
                             n_devices=n, seed=4, verbose=False)
        pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=exact)
        assert (pipe.mesh is None) == (n is None)
        return pipe.run()

    assert run(8)["final_energy"] == pytest.approx(
        run(None)["final_energy"], abs=PIPE_TOL)


def test_dryrun_multichip_on_cpu():
    from flow_guided_krylov_torch.examples.graft_entry import \
        dryrun_multichip
    out = dryrun_multichip(8, device="cpu")
    assert out["mesh_shape"] == {"data": 4, "basis": 2}
    assert np.isfinite(out["step_energy"])
    assert abs(out["e_mesh"] - out["e_single"]) < PIPE_TOL
    assert abs(out["e_mesh"] - out["exact"]) < 1.6e-3
