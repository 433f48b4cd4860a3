"""Port parity: the subspace-energy trainer (``flows/training.py``) against
the JAX package on the CPU.

Both trainers start from one state (``convert.load_trainer_from_jax``:
params and Adam moments); the port is fed the uniforms the JAX trainer
draws from its own key split, so the two sample the same determinants.
The JAX step runs at its padded capacity, the port's on the valid rows.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu import pipeline as jpipe
from flow_guided_krylov_tpu.flows import particle_conserving as jpc
from flow_guided_krylov_tpu.flows import training as jtr
from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.models import dense as jdense
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch import pipeline as ppipe
from flow_guided_krylov_torch.flows import particle_conserving as ppc
from flow_guided_krylov_torch.flows import training as ptr
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.models import dense as pdense

torch.set_num_threads(1)

# the host float64 H: the same Slater-Condon elements, symmetrized
HOST_H_ATOL = 1e-10
# the device float32 H against the f64 one: float32 elements, held to a
# few ulps of the largest |H_ij|
DEVICE_H_RTOL = 1e-6
# Rayleigh quotients and flow losses: float32 sums in another order
ENERGY_RTOL = 2e-6
# Adam's u = m/(sqrt(v)+eps) can turn a rounding difference in a gradient
# near 0 into a step of up to lr: parameters are held to 5 % of lr a step
PARAM_LR_FRACTION = 0.05
# the moments hold the gradients' rounding: 2e-5 of the largest moment
MOMENT_RTOL = 2e-5


@pytest.fixture(autouse=True)
def _integral_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path / "integrals"))


@functools.lru_cache(maxsize=None)
def _hams(name):
    jh = jmol.MOLECULE_FACTORIES[name]()
    return jh, pmol.MolecularHamiltonian(jh.integrals, "cpu")


def _trainers(name, hidden=(32, 32), **cfg):
    jh, ph = _hams(name)
    n, na, nb = jh.n_orbitals, jh.n_alpha, jh.n_beta
    kw = dict(samples_per_batch=64, verbose=False, seed=2, **cfg)
    jt = jtr.FlowNQSTrainer(
        jh, jpc.ParticleConservingFlow(n_orbitals=n, n_alpha=na, n_beta=nb,
                                       hidden_dims=hidden),
        jdense.DenseNQS(num_sites=2 * n, hidden_dims=hidden),
        jtr.TrainingConfig(**kw))
    pt = ptr.FlowNQSTrainer(ph, ppc.ParticleConservingFlow(n, na, nb, hidden),
                            pdense.DenseNQS(2 * n, hidden),
                            ptr.TrainingConfig(**kw))
    convert.load_trainer_from_jax(pt, jt)
    return jt, pt


def _jax_step(jt):
    """The JAX train loop's step on its current cache; the energy."""
    cap = jt._capacity(len(jt.cache))
    H_pad, occ_pad, mask = jt._padded_inputs(cap)
    (jt.nqs_params, jt.flow_params, jt.nqs_opt_state, jt.flow_opt_state,
     e, _) = jt._get_step(cap)(jt.nqs_params, jt.flow_params,
                               jt.nqs_opt_state, jt.flow_opt_state,
                               H_pad, occ_pad, mask)
    return float(e)


def _jax_epoch(jt):
    """One epoch of the JAX train loop; returns its energy and the
    (alpha, beta) uniforms its flow sample drew."""
    k = jax.random.split(jt.key)[1]
    B, n = jt.config.samples_per_batch, jt.h.n_orbitals
    u = tuple(torch.from_numpy(np.array(jax.random.uniform(
        kk, (B, n), minval=1e-10, maxval=1.0)))
        for kk in jax.random.split(k))
    jt._sample_and_accumulate()
    jt._prune_if_needed()
    return _jax_step(jt), u


def _compare_params(jt, pt, n_steps):
    for tree, module, lr, conv in (
            (jt.flow_params, pt.flow, jt.config.flow_lr,
             convert.particle_flow_state_dict),
            (jt.nqs_params, pt.nqs, jt.config.nqs_lr,
             convert.dense_nqs_state_dict)):
        want = conv(tree)
        for name, p in module.state_dict().items():
            np.testing.assert_allclose(
                p.numpy(), want[name].numpy(), rtol=0,
                atol=PARAM_LR_FRACTION * lr * n_steps, err_msg=name)


def _compare_moments(jt, pt):
    for name, conv in (("flow", convert.particle_flow_state_dict),
                       ("nqs", convert.dense_nqs_state_dict)):
        module = getattr(pt, name)
        want = convert.adam_state_dict(getattr(jt, name + "_opt_state"),
                                       conv, module)
        got = getattr(pt, name + "_opt").state_dict()
        assert got["count"] == want["count"]
        for key in ("mu", "nu"):
            scale = max(float(w.abs().max()) for w in want[key])
            for g, w in zip(got[key], want[key]):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                           atol=MOMENT_RTOL * scale)


def test_incremental_cache_matches_jax():
    """extend / extend / restrict / extend on LiH: the same basis, the
    host f64 H to 1e-10 and the device f32 H to f32 of the JAX cache."""
    jh, ph = _hams("lih")
    basis = jh.enumerate_basis()
    rng = np.random.default_rng(0)
    perm = basis[rng.permutation(len(basis))]
    keep = np.sort(rng.choice(90, 50, replace=False))
    jc, pc = jtr.IncrementalHamiltonianCache(jh), \
        ptr.IncrementalHamiltonianCache(ph, capacity=96)
    for c in (jc, pc):
        c.extend(perm[:40])
        c.extend(perm[40:90])
        c.restrict(keep)
        c.extend(perm[90:130])
    np.testing.assert_array_equal(pc.basis, jc.basis)
    np.testing.assert_allclose(pc.H, jc.H, rtol=0, atol=HOST_H_ATOL)
    scale = float(np.abs(jc.H).max())
    np.testing.assert_allclose(pc.H_device.double().numpy(), jc.H, rtol=0,
                               atol=DEVICE_H_RTOL * scale)
    assert pc.peak_rows == 90 and len(pc) == 90
    # past its capacity the buffer grew, keeping what it held
    assert pc._H.shape[0] >= 90 and pc.device_bytes > 0
    np.testing.assert_array_equal(pc.H_device.numpy(), pc.H_device.numpy().T)


def test_sorted_key_dedup_masks_are_bit_equal():
    rng = np.random.default_rng(1)
    jd, pd = jtr._SortedKeyDedup(), ptr._SortedKeyDedup()
    for _ in range(6):
        keys = rng.integers(0, 400, 150).astype(np.uint64) << np.uint64(20)
        np.testing.assert_array_equal(pd.filter_new(keys),
                                      jd.filter_new(keys))
        np.testing.assert_array_equal(pd.keys, jd.keys)
    kept = jd.keys[::3].copy()
    jd.remove_to(kept[::-1])
    pd.remove_to(kept[::-1])
    np.testing.assert_array_equal(pd.keys, jd.keys)


def test_one_step_from_one_converted_state_matches_jax():
    """A step from fresh Adam states, then a second from the JAX trainer's
    converted params and moments: energy, params and both Adam states."""
    jt, pt = _trainers("lih")
    basis = jt.h.enumerate_basis()
    rng = np.random.default_rng(3)
    dets = basis[np.sort(rng.choice(len(basis), 120, replace=False))]
    jt.cache.extend(dets)
    pt.cache.extend(dets)
    for step in range(2):
        e_j = _jax_step(jt)
        e_p, _ = pt._step()
        assert float(e_p) == pytest.approx(e_j, rel=ENERGY_RTOL)
        _compare_params(jt, pt, 1)
        _compare_moments(jt, pt)
        # the next step starts both from the JAX trainer's state
        convert.load_trainer_from_jax(pt, jt)
    assert pt.nqs_opt.count == 2


@pytest.mark.parametrize("name,epochs,cap", [("h2", 4, 2048),
                                             ("lih", 6, 60)])
def test_epochs_fed_jax_samples_give_the_same_bases(name, epochs, cap):
    """A few epochs, the port fed the JAX trainer's uniforms: the same
    accumulated basis after each (LiH prunes from 60 to 54 rows), and
    f32-close energies and params."""
    jt, pt = _trainers(name, max_basis_size=cap)
    pruned = False
    for epoch in range(epochs):
        e_j, u = _jax_epoch(jt)
        e_p = pt._epoch(uniforms=u)
        np.testing.assert_array_equal(pt.cache.basis, jt.cache.basis)
        np.testing.assert_array_equal(pt.dedup.keys, jt.dedup.keys)
        assert e_p == pytest.approx(e_j, rel=ENERGY_RTOL)
        pruned |= len(jt.cache) == int(cap * 0.9)
    assert pruned == (name == "lih")
    _compare_params(jt, pt, epochs)
    np.testing.assert_array_equal(pt.extract_basis(20),
                                  jt.extract_basis(20))


def test_train_history_and_convergence_match_jax():
    """``train`` on H2: the JAX history's keys; the energy falls well
    below its start (the JAX test's criterion) and the basis completes."""
    jt, pt = _trainers("h2", num_epochs=120, min_epochs=60, patience=40)
    hist = pt.train()
    assert sorted(hist) == sorted(jt.history)
    assert len(hist["energies"]) == len(hist["basis_sizes"]) \
        == len(hist["epoch_times"])
    e = hist["energies"]
    assert min(e) < e[0] - 0.2 and min(e) < -1.0
    assert len(pt.extract_basis()) == 4


class _JaxProxy(types.SimpleNamespace):
    """The ``jax`` module seen by the JAX training module, with ``jit``
    replaced (every other name passes through)."""

    def __getattr__(self, name):
        return getattr(jax, name)


def test_inference_trainer_plateau_schedule_matches_jax(monkeypatch):
    """A scripted energy sequence (gradients zero) through both trainers'
    plateau logic: the same rate halvings (1e-3 -> 5e-4 -> 2.5e-4, each a
    fresh Adam) at the same epochs, and the stop on the third plateau."""
    jh, ph = _hams("lih")
    basis = jh.enumerate_basis()[:30]
    script = list(np.linspace(-7.0, -7.5, 12)) + [-7.5] * 200
    patience = 5

    calls = {"n": 0}

    def scripted_jit(fn):
        def run(params):
            e = script[calls["n"]]
            calls["n"] += 1
            return (jnp.float32(e),
                    jax.tree_util.tree_map(jnp.zeros_like, params))
        return run

    lrs = []
    optax = jtr.optax

    def adam(lr):
        lrs.append(lr)
        return optax.adam(lr)

    monkeypatch.setattr(jtr, "jax", _JaxProxy(jit=scripted_jit))
    monkeypatch.setattr(jtr, "optax", types.SimpleNamespace(
        adam=adam, apply_updates=optax.apply_updates))
    jt = jtr.InferenceNQSTrainer(jh, jdense.DenseNQS(num_sites=12,
                                                     hidden_dims=(8,)),
                                 basis, num_epochs=500, patience=patience)
    jhist = jt.train()

    pt = ptr.InferenceNQSTrainer(ph, pdense.DenseNQS(12, (8,)), basis,
                                 num_epochs=500, patience=patience)
    step = {"n": 0}

    def energy_and_grad():
        e = script[step["n"]]
        step["n"] += 1
        return (torch.tensor(e, dtype=torch.float32),
                [torch.zeros_like(p) for p in pt.nqs.parameters()])

    pt._energy_and_grad = energy_and_grad
    phist = pt.train()
    assert [lr for _, lr in pt.lr_schedule] == lrs == [1e-3, 5e-4, 2.5e-4]
    assert phist["energies"] == pytest.approx(jhist["energies"], abs=0)
    assert len(phist["energies"]) == 12 + 3 * patience


def test_inference_trainer_on_lih_matches_jax_then_plateaus():
    """From one converted NQS on LiH's 225 determinants: 20 epochs equal
    to f32 (the packages' rounding then steers the plateau counts apart);
    then the port alone through its two halvings to the stop, never below
    the basis's exact ground energy."""
    jh, ph = _hams("lih")
    basis = jh.enumerate_basis()
    jt = jtr.InferenceNQSTrainer(
        jh, jdense.DenseNQS(num_sites=12, hidden_dims=(32, 32)), basis,
        num_epochs=20)
    pt = ptr.InferenceNQSTrainer(ph, pdense.DenseNQS(12, (32, 32)), basis,
                                 num_epochs=20)
    pt.nqs.load_state_dict(convert.dense_nqs_state_dict(jt.params))
    np.testing.assert_allclose(pt.H.double().numpy(), np.asarray(jt.H),
                               rtol=0, atol=DEVICE_H_RTOL * 8.0)
    want = jt.train()["energies"]
    got = pt.train()["energies"]
    np.testing.assert_allclose(got, want, rtol=ENERGY_RTOL)

    # at 1e-2 the plateaus come within ~2,700 epochs (at 1e-3, ~10,000)
    full = ptr.InferenceNQSTrainer(ph, pdense.DenseNQS(12, (32, 32)), basis,
                                   lr=1e-2, num_epochs=6000, patience=10)
    e = full.train()["energies"]
    e0 = float(ph.exact_ground_state(basis, k=1)[0][0])
    assert [lr for _, lr in full.lr_schedule] == [1e-2, 5e-3, 2.5e-3]
    assert len(e) < 6000 and min(e) < e[0]
    assert min(e) >= e0 - 1e-6


def test_subspace_pipeline_matches_jax_results():
    """``use_local_energy=False`` through ``run()`` on H2 in both: stage 1
    in ``subspace_energy`` mode, the JAX results keys, FCI reached; stage
    2 reads the trainer's accumulated basis (its cache's)."""
    kw = dict(use_local_energy=False, max_epochs=40, min_epochs=20,
              samples_per_batch=128, nqs_hidden_dims=[32, 32],
              nf_hidden_dims=[32, 32], max_krylov_dim=2,
              shots_per_krylov=2000, verbose=False)
    jh = jmol.create_h2_hamiltonian()
    jp = jpipe.FlowGuidedKrylovPipeline(jh, jpipe.PipelineConfig(**kw),
                                        exact_energy=jh.fci_energy())
    jout = jp.run()
    ph = pmol.MolecularHamiltonian(jh.integrals, "cpu")
    pp = ppipe.FlowGuidedKrylovPipeline(ph, ppipe.PipelineConfig(**kw),
                                        exact_energy=ph.fci_energy())
    pout = pp.run()
    assert pp.results["stage1"]["mode"] == jp.results["stage1"]["mode"] \
        == "subspace_energy"
    assert sorted(pout) == sorted(jout)
    for stage in ("stage1", "stage2", "stage3", "stage4"):
        assert sorted(pp.results[stage]) == sorted(jp.results[stage]), stage
    assert sorted(pp.results["stage1"]["history"]) == \
        sorted(jp.results["stage1"]["history"])
    assert isinstance(pp.trainer, ptr.FlowNQSTrainer)
    np.testing.assert_array_equal(pp.trainer.accumulated_basis,
                                  pp.trainer.cache.basis)
    assert pout["chemical_accuracy"] and abs(pout["error_mha"]) < 0.01
