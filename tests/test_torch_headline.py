"""Port parity: stages 2-4 of the molecular pipeline from one stage-1 state,
against the JAX package on the CPU, at the medium tier of the published
seven-molecule table (``examples/benchmark.py --molecule all``).

The JAX pipeline trains stage 1 for a few epochs; its trainer (both
networks, both Adam states and the accumulated basis) is carried into the
port's pipeline with ``convert.load_trainer_from_jax``.  Both packages then
run ``extract_and_select_basis``, ``run_residual_expansion`` and
``run_skqd``.  BeH2 keeps its whole accumulated basis (the medium tier's
diversity cap is the space); NH3 runs with ``max_diverse_configs`` below
its accumulated count, so the NQS-weighted probabilities and the greedy
diversity selection decide stage 2.
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu import pipeline as jpipe
from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch import pipeline as ppipe
from flow_guided_krylov_torch.flows import physics_guided_training as ppg
from flow_guided_krylov_torch.hamiltonians import molecular as pmol

torch.set_num_threads(1)

# f64 eigensolves of one basis by two packages (host eigsh or Davidson)
ENERGY_TOL = 1e-8
# five NQS layers keep the medium tier's widths from being raised to
# [384]*5; the stage-1 state is what is carried, its size is not the point
STAGE1 = dict(max_epochs=6, min_epochs=2, samples_per_batch=256,
              nqs_hidden_dims=[32] * 5, nf_hidden_dims=[32, 32],
              max_krylov_dim=3, shots_per_krylov=5000, seed=5,
              verbose=False)


@pytest.fixture(autouse=True)
def _integral_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path / "integrals"))


def _pipelines(name, **after_tier):
    """The JAX pipeline after its stage 1 and the port's pipeline holding
    the carried trainer; ``after_tier`` edits both configs after the size
    tier set them."""
    jh = jmol.MOLECULE_FACTORIES[name]()
    ph = pmol.MolecularHamiltonian(jh.integrals, "cpu")
    fci = jh.fci_energy()
    jp = jpipe.FlowGuidedKrylovPipeline(
        jh, jpipe.PipelineConfig(**STAGE1), exact_energy=fci)
    pp = ppipe.FlowGuidedKrylovPipeline(
        ph, ppipe.PipelineConfig(**STAGE1), exact_energy=fci)
    for p in (jp, pp):
        for k, v in after_tier.items():
            setattr(p.config, k, v)
    jp.train_flow_nqs()
    c = pp.config
    pp.trainer = ppg.PhysicsGuidedFlowTrainer(
        ph, pp.flow, pp.nqs, ppg.PhysicsGuidedConfig(
            samples_per_batch=c.samples_per_batch,
            max_accumulated_basis=c.max_accumulated_basis, verbose=False))
    convert.load_trainer_from_jax(pp.trainer, jp.trainer)
    return jp, pp


def _stages_2_to_4(p):
    p.extract_and_select_basis()
    p.run_residual_expansion()
    p.run_skqd()
    return p.results


@pytest.mark.parametrize("name,after_tier", [
    ("beh2", {}),
    ("nh3", {"max_diverse_configs": 300}),
])
def test_stages_2_to_4_match_jax_from_one_stage1_state(name, after_tier):
    jp, pp = _pipelines(name, **after_tier)
    assert pp.config.nqs_hidden_dims == jp.config.nqs_hidden_dims
    np.testing.assert_array_equal(pp.trainer.accumulated_basis,
                                  jp.trainer.accumulated_basis)
    n_acc = len(jp.trainer.accumulated_basis)
    if after_tier:
        assert n_acc > pp.config.max_diverse_configs
    jr, pr = _stages_2_to_4(jp), _stages_2_to_4(pp)

    # stage 2: the same selected determinants, in the same order
    np.testing.assert_array_equal(pp.nf_basis, jp.nf_basis)
    assert pr["stage2"]["audit"] == jr["stage2"]["audit"]
    assert pr["stage2"]["nf_energy"] == pytest.approx(
        jr["stage2"]["nf_energy"], abs=ENERGY_TOL)
    if after_tier:
        assert pr["stage2"]["selection_stats"] == jr["stage2"][
            "selection_stats"]

    # stage 3: every round's basis size and energy
    j3, p3 = jr["stage3"], pr["stage3"]
    assert p3["n_iterations"] == j3["n_iterations"] >= 1
    np.testing.assert_allclose(p3["energies"], j3["energies"], rtol=0,
                               atol=ENERGY_TOL)
    assert p3["basis_size"] == j3["basis_size"]
    np.testing.assert_array_equal(np.sort(pp.h.keys(p3["basis"])),
                                  np.sort(jp.h.keys(j3["basis"])))
    assert p3["energy"] == pytest.approx(j3["energy"], abs=ENERGY_TOL)

    # stage 4: the same decision
    j4, p4 = jr["stage4"], pr["stage4"]
    assert p4["skipped"] == j4["skipped"]
    assert p4.get("reason") == j4.get("reason")
