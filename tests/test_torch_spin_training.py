"""Port parity: the spin stage-1 trainer (``SpinFlowTrainer``) against the
JAX package on the CPU.

The port is fed the JAX step's own samples and Monte Carlo noise,
recomputed from its key split, and starts from the JAX networks'
parameters (through ``convert``), so both trainers take the same steps.
The JAX step's ``unique_compact`` is read from its closure
(``_step.__wrapped__``), as ``tests/test_torch_stage1.py`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.flows import discrete as jdisc
from flow_guided_krylov_tpu.flows import particle_conserving as jpc
from flow_guided_krylov_tpu.flows import physics_guided_training as jpg
from flow_guided_krylov_tpu.flows import spin_training as jst
from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.models import dense as jdense
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch.flows import discrete as pdisc
from flow_guided_krylov_torch.flows import particle_conserving as ppc
from flow_guided_krylov_torch.flows import physics_guided_training as ppg
from flow_guided_krylov_torch.flows import spin_training as pst
from flow_guided_krylov_torch.models import dense as pdense

torch.set_num_threads(1)

METRIC_RTOL = 1e-5
PARAM_ATOL = {1: 1e-5, 5: 1e-4}     # after this many steps
HIDDEN = (16, 16)
N_MC = 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _closure(jt):
    f = jt._step.__wrapped__
    return dict(zip(f.__code__.co_freevars,
                    (c.cell_contents for c in f.__closure__)))


MODELS = {
    # TFIM-8 through the discrete flow, B = 96 of 256 states (duplicates)
    "tfim8": dict(B=96),
    # Heisenberg-8 in its S_z = 0 sector (70 states) through the S_z flow
    "heis8": dict(B=96),
}


def _pair(model, max_basis=4096, epochs=20):
    B = MODELS[model]["B"]
    if model == "tfim8":
        jh = jspin.TransverseFieldIsing(8, V=1.0, h=0.7, periodic=True)
        jflow = jdisc.DiscreteFlowSampler(n_sites=8, hidden=16)
        pflow = pdisc.DiscreteFlowSampler(8, hidden=16)
        fconv = convert.discrete_flow_state_dict
    else:
        jh = jspin.HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                                         h_z=np.full(8, 0.05))
        jflow = jpc.SzConservingFlow(n_sites=8, n_up=4)
        pflow = ppc.SzConservingFlow(8, 4)
        fconv = convert.sz_flow_state_dict
    ph = convert.spin_hamiltonian_from_jax(jh, "cpu")
    kw = dict(samples_per_batch=B, max_accumulated_basis=max_basis,
              num_epochs=epochs, min_epochs=2, seed=3, verbose=False)
    jt = jst.SpinFlowTrainer(jh, jflow, jdense.DenseNQS(
        num_sites=8, hidden_dims=HIDDEN), jpg.PhysicsGuidedConfig(**kw),
        n_mc_prob=N_MC)
    pt = pst.SpinFlowTrainer(ph, pflow, pdense.DenseNQS(8, HIDDEN),
                             ppg.PhysicsGuidedConfig(**kw), n_mc_prob=N_MC)
    pt.flow.load_state_dict(fconv(_np_tree(jt.flow_params)))
    pt.nqs.load_state_dict(
        convert.dense_nqs_state_dict(_np_tree(jt.nqs_params)))
    return jt, pt, fconv


def _jax_step(jt):
    """One step of ``SpinFlowTrainer.train``; returns the samples, the
    sampler's noise and the Monte Carlo noise recomputed from the step's
    key split, and the metrics."""
    B, n = jt.config.samples_per_batch, jt.h.n_sites
    jt.key, k = jax.random.split(jt.key)
    k_samp, k_prob = jax.random.split(k)
    configs, _ = jt.flow.apply(jt.flow_params, k_samp, B,
                               method=jt.flow.sample)
    if isinstance(jt.flow, jdisc.DiscreteFlowSampler):
        k1, k2 = jax.random.split(k_samp)
        noise = (2.0 * _t(jax.random.bernoulli(k1, 0.5, (B, n))).float()
                 - 1.0, _t(jax.random.normal(k2, (B, n))))
        eps = _t(jax.random.normal(k_prob, (N_MC, B, n)))
    else:
        noise = _t(jax.random.uniform(k_samp, (B, n), minval=1e-10,
                                      maxval=1.0))
        eps = None
    (jt.flow_params, jt.nqs_params, jt.flow_opt_state, jt.nqs_opt_state,
     packed_u, n_unique, metrics) = jt._step(
        jt.flow_params, jt.nqs_params, jt.flow_opt_state, jt.nqs_opt_state,
        k)
    jt._accumulate(np.asarray(packed_u), int(n_unique))
    return (np.round(np.asarray(configs)).astype(np.float32), noise, eps,
            {k_: float(v) for k_, v in metrics.items()})


def _compare_params(jt, pt, fconv, atol):
    for tree, module, conv in ((jt.flow_params, pt.flow, fconv),
                               (jt.nqs_params, pt.nqs,
                                convert.dense_nqs_state_dict)):
        want = conv(_np_tree(tree))
        for name, p in module.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("model", list(MODELS))
def test_steps_match_jax(model):
    """Five steps: the samples bit for bit, the metrics to 1e-5 relative,
    the parameters to 1e-5 after one step and 1e-4 after five, the
    accumulated basis bit for bit, finite gradients with padded rows."""
    jt, pt, fconv = _pair(model)
    for step in range(1, 6):
        configs, noise, eps, jm = _jax_step(jt)
        got = pt.sample(noise=noise)
        np.testing.assert_array_equal(got.numpy(), configs)
        pm = pt.update(got, eps=eps)
        assert jm["unique_ratio"] < 1.0           # padded rows in the batch
        # n_unique / B in float32 (the JAX step rounds it one ulp apart)
        assert pm["unique_ratio"] == pytest.approx(jm["unique_ratio"],
                                                   rel=1e-6)
        scale = max(abs(jm["energy"]), abs(jm["teacher_loss"]),
                    abs(jm["entropy"]))
        for key in ("energy", "teacher_loss", "physics_loss", "entropy"):
            assert abs(pm[key] - jm[key]) <= METRIC_RTOL * scale, key
        for prm in list(pt.flow.parameters()) + list(pt.nqs.parameters()):
            assert torch.isfinite(prm).all()
        np.testing.assert_array_equal(pt.accumulated_basis,
                                      jt.accumulated_basis)
        if step in PARAM_ATOL:
            _compare_params(jt, pt, fconv, PARAM_ATOL[step])


def test_unique_compact_matches_jax():
    jt, pt, _ = _pair("tfim8")
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 40, 96).astype(np.uint32)     # with repeats
    want, n_want = _closure(jt)["unique_compact"](jnp.asarray(packed))
    got, n_got = pt._unique_compact(torch.from_numpy(packed.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    assert int(n_got) == int(n_want) < 96


def test_accumulate_above_the_cap_is_bit_equal():
    jt, pt, _ = _pair("tfim8", max_basis=50)
    rng = np.random.default_rng(5)
    for _ in range(4):
        packed = np.sort(rng.choice(256, 40, replace=False)).astype(np.uint32)
        n = int(rng.integers(20, 40))
        jt._accumulate(packed, n)
        pt._accumulate(packed, n)
        np.testing.assert_array_equal(pt.accumulated_basis,
                                      jt.accumulated_basis)
    assert len(pt.accumulated_basis) == 50


def test_train_keeps_the_history_keys_and_stops_on_convergence():
    """``train`` on the card-free path: the JAX trainer's history keys, an
    EMA of the energy, and the unique-ratio stop after ``min_epochs``."""
    jt, pt, _ = _pair("heis8", epochs=40)
    pt.config.convergence_threshold = 1.0        # any step converges
    hist = pt.train()
    assert sorted(hist) == sorted(jt.history)
    assert len(hist["energies"]) == pt.config.min_epochs + 1
    assert pt.energy_ema is not None and np.isfinite(pt.energy_ema)
    assert hist["basis_sizes"][-1] == len(pt.accumulated_basis) <= 70
    assert (pt.accumulated_basis[:, 0] != 0).all()
    popcount = np.array([bin(int(x)).count("1")
                         for x in pt.accumulated_basis[:, 0]])
    assert (popcount == 4).all()
