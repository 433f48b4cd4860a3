"""Port parity: the pipeline's spin branches
(``flow_guided_krylov_torch.pipeline``) against the JAX pipeline on the
CPU: the constructor's routing, stage 2's top-|psi|^2 selection and stage
3 fed the JAX trainer's basis and NQS, the stage-4 skip rule, the results
keys, and the port's pipeline end to end on the reference's own spin
tests."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu import pipeline as jpipe
from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch import pipeline as ppipe
from flow_guided_krylov_torch.flows.physics_guided_training import \
    PhysicsGuidedConfig
from flow_guided_krylov_torch.flows.spin_training import SpinFlowTrainer
from flow_guided_krylov_torch.hamiltonians import molecular as pmol

torch.set_num_threads(1)

SMALL = dict(max_epochs=12, min_epochs=4, samples_per_batch=128,
             nqs_hidden_dims=[16, 16], nf_hidden_dims=[64, 64],
             max_krylov_dim=3, shots_per_krylov=2000, verbose=False)


def _model(name):
    if name == "tfim6":
        return jspin.TransverseFieldIsing(6, V=1.0, h=0.6)
    if name == "tfim8":
        return jspin.TransverseFieldIsing(8, V=1.0, h=0.5, periodic=True)
    if name == "heis8-hx":
        return jspin.HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                                           h_x=np.full(8, 0.3))
    n = int(name[4:])
    return jspin.HeisenbergHamiltonian(n, 1.0, 1.0, 1.0,
                                       h_z=np.array([0.1] + [0.0] * (n - 1)))


def _pair(name, **cfg):
    jh = _model(name)
    ph = convert.spin_hamiltonian_from_jax(jh, "cpu")
    kw = dict(SMALL, **cfg)
    jp = jpipe.FlowGuidedKrylovPipeline(jh, jpipe.PipelineConfig(**kw))
    pp = ppipe.FlowGuidedKrylovPipeline(ph, ppipe.PipelineConfig(**kw))
    return jp, pp


CASES = [("tfim6", {}), ("heis8", {}), ("heis8-hx", {}),
         ("heis8", {"use_particle_conserving_flow": False})]


@pytest.mark.parametrize("name,cfg", CASES,
                         ids=["tfim6", "heis8", "heis8-hx", "heis8-discrete"])
def test_constructor_routes_like_jax(name, cfg):
    """The flow, the search-space size, the reference state and the
    adapted config: S_z-conserving models sample their sector, the others
    all 2^n states through the discrete flow."""
    jp, pp = _pair(name, **cfg)
    assert type(pp.flow).__name__ == type(jp.flow).__name__
    assert pp.n_valid == jp.n_valid
    assert pp._spin_sector_n_up == jp._spin_sector_n_up
    np.testing.assert_array_equal(pp.hf_state, jp.hf_state)
    assert dataclasses.asdict(pp.config) == dataclasses.asdict(jp.config)
    if type(pp.flow).__name__ == "DiscreteFlowSampler":
        assert pp.flow.hidden == jp.flow.hidden == 64
    else:
        assert pp.flow.n_up == jp.flow.n_up == 4


def _port_trainer_from_jax(pp, jp):
    """A port SpinFlowTrainer holding the JAX trainer's NQS and
    accumulated basis."""
    pt = SpinFlowTrainer(pp.h, pp.flow, pp.nqs, PhysicsGuidedConfig(
        num_epochs=1, verbose=False))
    pt.nqs.load_state_dict(convert.dense_nqs_state_dict(
        jax.tree_util.tree_map(np.asarray, jp.trainer.nqs_params)))
    pt.accumulated_basis = np.array(jp.trainer.accumulated_basis)
    return pt


@pytest.mark.parametrize("name", ["heis10", "tfim8"])
def test_stages_2_and_3_fed_the_jax_trainer_match(name):
    """Stage 2 keeps the same configurations bit for bit (the NQS's
    largest |psi|^2, the reference state added), stage 3 the same
    Selected-CI energies to 1e-8 Ha."""
    jp, pp = _pair(name, max_diverse_configs=60, residual_iterations=4,
                   residual_configs_per_iter=10)
    jp.config.max_diverse_configs = pp.config.max_diverse_configs = 60
    jp.train_flow_nqs()
    pp.trainer = _port_trainer_from_jax(pp, jp)
    assert len(jp.trainer.accumulated_basis) > 60
    j2, p2 = jp.extract_and_select_basis(), pp.extract_and_select_basis()
    np.testing.assert_array_equal(pp.nf_basis, jp.nf_basis)
    assert p2["nf_energy"] == pytest.approx(j2["nf_energy"], abs=1e-8)
    assert p2["selection_stats"] == j2["selection_stats"]
    assert p2["audit"] == j2["audit"] == {"spin": True}
    j3, p3 = jp.run_residual_expansion(), pp.run_residual_expansion()
    np.testing.assert_array_equal(p3["basis"], j3["basis"])
    np.testing.assert_allclose(p3["energies"], j3["energies"], rtol=0,
                               atol=1e-8)
    assert p3["energy"] < p2["nf_energy"]


def test_tfim_pipeline_end_to_end():
    """``tests/test_spin_pipeline.py``'s run through the port: TFIM-6 by
    the discrete flow, within 1.6 mHa and variational."""
    h = convert.spin_hamiltonian_from_jax(_model("tfim6"), "cpu")
    e_exact = float(np.linalg.eigvalsh(h.exact_dense())[0])
    cfg = ppipe.PipelineConfig(max_epochs=80, min_epochs=30,
                               samples_per_batch=256,
                               nqs_hidden_dims=[64, 64],
                               nf_hidden_dims=[64, 64], max_krylov_dim=4,
                               shots_per_krylov=5000, verbose=False)
    pipe = ppipe.FlowGuidedKrylovPipeline(h, cfg, exact_energy=e_exact)
    out = pipe.run()
    assert out["chemical_accuracy"], out["error_mha"]
    assert out["final_energy"] >= e_exact - 1e-9
    assert pipe.results["stage1"]["mode"] == "spin"
    assert pipe.trainer.device == torch.device("cpu")


def test_sz_conserving_pipeline_end_to_end():
    """``tests/test_spin.py``'s Heisenberg-8 run through the port: the
    S_z flow in the 70-state sector, within 1.6 mHa."""
    h = convert.spin_hamiltonian_from_jax(_model("heis8"), "cpu")
    e_exact = float(np.linalg.eigvalsh(h.exact_dense())[0])
    cfg = ppipe.PipelineConfig(max_epochs=60, min_epochs=20,
                               samples_per_batch=512,
                               nqs_hidden_dims=[128, 128], skip_skqd=True,
                               use_residual_expansion=False, verbose=False)
    pipe = ppipe.FlowGuidedKrylovPipeline(h, cfg, exact_energy=e_exact)
    assert type(pipe.flow).__name__ == "SzConservingFlow"
    assert pipe.n_valid == 70
    out = pipe.run()
    assert abs(out["final_energy"] - e_exact) < 1.6e-3
    pops = {bin(int(x)).count("1") for x in pipe.nf_basis[:, 0]}
    assert pops == {4}


def test_results_keys_match_jax_on_spins():
    jp, pp = _pair("tfim6", max_epochs=6, min_epochs=2)
    jout, pout = jp.run(), pp.run()
    assert sorted(pout) == sorted(jout)
    assert sorted(pp.results) == sorted(jp.results)
    for stage in ("stage1", "stage2", "stage3", "stage4"):
        assert sorted(pp.results[stage]) == sorted(jp.results[stage]), stage
    assert sorted(pp.results["stage1"]["history"]) == \
        sorted(jp.results["stage1"]["history"])


def test_stage4_runs_in_the_sector_and_skips_past_the_statevector_cap():
    """Stage 4 evolves a spin basis (here Heisenberg-12's sector, no exact
    energy given) and skips, with the JAX package's reason, past the
    statevector cap."""
    jh = _model("heis12")
    h = convert.spin_hamiltonian_from_jax(jh, "cpu")
    pipe = ppipe.FlowGuidedKrylovPipeline(h, ppipe.PipelineConfig(**SMALL))
    basis = np.sort(np.random.default_rng(0).choice(
        [x for x in range(1 << 12) if bin(x).count("1") == 6], 310,
        replace=False)).astype(np.uint32)[:, None]
    e3 = float(h.exact_ground_state(basis, k=1)[0][0])
    pipe.nf_basis = basis
    pipe.results["stage3"] = {"energy": e3, "basis": basis}
    out = pipe.run_skqd()
    assert not out["skipped"] and out["final_energy"] <= e3
    pipe._statevector_sites_cap = lambda: 11
    jp = jpipe.FlowGuidedKrylovPipeline(jh, jpipe.PipelineConfig(**SMALL))
    jp._statevector_sites_cap = lambda: 11
    jp.nf_basis = basis
    jp.results["stage3"] = {"energy": e3, "basis": basis}
    skip, jskip = pipe.run_skqd(), jp.run_skqd()
    assert skip["skipped"] and skip["reason"] == jskip["reason"]
    assert skip["final_energy"] == e3


def test_molecular_discrete_flow_raises_where_the_reference_fails():
    """``use_particle_conserving_flow=False`` on a molecule: the JAX
    pipeline fails in its constructor (spin reference states fed to the
    molecular diagonal), so the port raises and names that failure."""
    kw = dict(SMALL, use_particle_conserving_flow=False)
    with pytest.raises(ValueError):
        jpipe.FlowGuidedKrylovPipeline(jmol.create_h2_hamiltonian(),
                                       jpipe.PipelineConfig(**kw))
    with pytest.raises(NotImplementedError, match="ValueError on H2"):
        ppipe.FlowGuidedKrylovPipeline(pmol.create_h2_hamiltonian("cpu"),
                                       ppipe.PipelineConfig(**kw))
