"""Port parity: the molecular pipeline (``flow_guided_krylov_torch.pipeline``)
and the stage-2/3 pieces it drives, against the JAX package on the CPU,
plus the port's pipeline end to end on the CPU at small widths (as
``tests/test_pipeline.py`` runs the JAX one)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu import pipeline as jpipe
from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_tpu.postprocessing import diversity_selection as jds
from flow_guided_krylov_torch import pipeline as ppipe
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import residual_expansion as pre
from flow_guided_krylov_torch.postprocessing import diversity_selection as pds

torch.set_num_threads(1)

SMALL = dict(max_epochs=80, min_epochs=30, samples_per_batch=256,
             nqs_hidden_dims=[64, 64], nf_hidden_dims=[64, 64],
             max_krylov_dim=3, shots_per_krylov=5000, verbose=False)


@pytest.mark.parametrize("n_valid", [1, 225, 1000, 1001, 4900, 14_400,
                                     20_001, 500_000, 500_001, 11_778_624])
def test_adapt_to_system_size_matches_jax(n_valid):
    j = jpipe.PipelineConfig(verbose=False).adapt_to_system_size(n_valid)
    p = ppipe.PipelineConfig(verbose=False).adapt_to_system_size(n_valid)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


def test_pipeline_config_defaults_match_jax():
    assert (dataclasses.asdict(ppipe.PipelineConfig())
            == dataclasses.asdict(jpipe.PipelineConfig()))
    assert ppipe.EnhancedFlowKrylovPipeline is ppipe.FlowGuidedKrylovPipeline
    assert ppipe.EnhancedPipelineConfig is ppipe.PipelineConfig


@pytest.mark.parametrize("n_pick,max_configs", [(400, 120), (3000, 900)])
def test_diversity_selector_is_bit_equal(n_pick, max_configs):
    """Rank buckets and the greedy DPP on a synthetic (10, 5a, 5b) space:
    the same determinants in the same order, and the same stats."""
    h = pmol.MolecularHamiltonian(pmol.synthetic_integrals(10, 5, 5, seed=1),
                                  device="cpu")
    rng = np.random.default_rng(13)
    basis = h.enumerate_basis()
    packed = basis[rng.integers(0, len(basis), n_pick)]
    probs = rng.random(n_pick)
    energies = h.diagonal_np(packed)
    hf = h.get_hf_state()
    cfg = dict(max_configs=max_configs, rank_2_fraction=0.5)
    got, gs = pds.DiversitySelector(hf, pds.DiversityConfig(**cfg)).select(
        packed, probs / probs.sum(), energies)
    want, ws = jds.DiversitySelector(hf, jds.DiversityConfig(**cfg)).select(
        packed, probs / probs.sum(), energies)
    np.testing.assert_array_equal(got, want)
    assert gs == ws and len(got) <= max_configs


@pytest.mark.parametrize("growth", [0.0, 0.5])
def test_expand_basis_n_add_trajectory_matches_jax(growth):
    """The pipeline's stage-3 loop with ``n_add`` from
    ``residual_growth_factor`` (0: the fixed schedule): the same bases
    and f64 energies round by round on H2O."""
    jh = jmol.create_h2o_hamiltonian()
    ph = pmol.MolecularHamiltonian(jh.integrals, "cpu")
    cfg = dict(configs_per_iteration=12, max_iterations=6, max_basis_size=400,
               residual_threshold=1e-6)
    je = jre.SelectedCIExpander(jh, jre.ResidualExpansionConfig(**cfg))
    pe = pre.SelectedCIExpander(ph, pre.ResidualExpansionConfig(**cfg))
    jb = pb = jh.get_hf_state()[None, :]
    for _ in range(6):
        n_add = max(12, int(growth * len(jb))) if growth else None
        jo = je.expand_basis(jb, n_add=n_add)
        po = pe.expand_basis(pb, n_add=n_add)
        jb, pb = jo["basis"], po["basis"]
        np.testing.assert_array_equal(pb, jb)
        assert po["n_added"] == jo["n_added"]
        assert po["energy"] == pytest.approx(jo["energy"], abs=1e-10)
    assert len(pb) > 6 * 12 if growth else len(pb) == 1 + 6 * 12


def test_h2_pipeline_end_to_end():
    h = pmol.create_h2_hamiltonian("cpu")
    fci = h.fci_energy()
    pipe = ppipe.FlowGuidedKrylovPipeline(h, ppipe.PipelineConfig(**SMALL),
                                          exact_energy=fci)
    out = pipe.run()
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.01
    for key in ("nf_energy", "residual_energy", "final_energy"):
        assert out[key] >= fci - 1e-9, key
    assert pipe.results["stage2"]["audit"]["all_valid"]
    assert pipe.trainer.device == torch.device("cpu")


def test_lih_pipeline_reaches_the_full_basis():
    h = pmol.create_lih_hamiltonian("cpu")
    fci = h.fci_energy()
    pipe = ppipe.FlowGuidedKrylovPipeline(h, ppipe.PipelineConfig(**SMALL),
                                          exact_energy=fci)
    out = pipe.run()
    assert pipe.trainer._acc_count == h.n_valid_configs == 225
    assert out["nf_basis_size"] == 225
    assert abs(out["error_mha"]) < 1.6
    assert out["residual_energy"] <= out["nf_energy"] + 1e-12
    assert pipe.results["stage4"]["skipped"]


def test_results_keys_match_jax():
    """The port's results dict and stage records carry the JAX pipeline's
    keys (H2, a few epochs on both)."""
    kw = dict(SMALL, max_epochs=6, min_epochs=2)
    jh = jmol.create_h2_hamiltonian()
    jp = jpipe.FlowGuidedKrylovPipeline(jh, jpipe.PipelineConfig(**kw),
                                        exact_energy=jh.fci_energy())
    jout = jp.run()
    ph = pmol.MolecularHamiltonian(jh.integrals, "cpu")
    pp = ppipe.FlowGuidedKrylovPipeline(ph, ppipe.PipelineConfig(**kw),
                                        exact_energy=ph.fci_energy())
    pout = pp.run()
    assert sorted(pout) == sorted(jout)
    assert sorted(pp.results) == sorted(jp.results)
    for stage in ("stage1", "stage2", "stage3", "stage4"):
        assert sorted(pp.results[stage]) == sorted(jp.results[stage]), stage
    assert sorted(pp.results["stage1"]["history"]) == \
        sorted(jp.results["stage1"]["history"])


def test_run_molecular_benchmark_on_cpu():
    assert inspect.signature(
        ppipe.run_molecular_benchmark).parameters["device"].default == "cuda"
    out = ppipe.run_molecular_benchmark(
        "h2", ppipe.PipelineConfig(**SMALL), device="cpu")
    assert out["molecule"] == "h2" and out["chemical_accuracy"]
    with pytest.raises(ValueError):
        ppipe.run_molecular_benchmark("he", device="cpu")


@pytest.mark.parametrize("field,value", [
    ("use_local_energy", False), ("checkpoint_dir", "ckpt"),
    ("n_devices", 2), ("use_particle_conserving_flow", False)])
def test_unported_options_raise(field, value, tmp_path):
    """Each option that still raises; ``use_local_energy=False`` and
    ``checkpoint_dir`` run alone and raise together (the JAX package's
    own run fails on the pair: ``tests/test_torch_checkpoint.py``).
    ``n_devices`` is ported: a Hamiltonian on the CPU gets a mesh of
    ``cpu`` entries, and what raises is a CUDA mesh wider than the host's
    cards (``tests/test_torch_parallel.py`` holds the mesh runs)."""
    h = pmol.create_h2_hamiltonian("cpu")
    if field == "n_devices":
        from flow_guided_krylov_torch.parallel import make_mesh
        pipe = ppipe.FlowGuidedKrylovPipeline(
            h, ppipe.PipelineConfig(verbose=False, n_devices=value))
        assert pipe.mesh.size == value and pipe.mesh.n_physical == 1
        with pytest.raises(RuntimeError, match="cards"):
            make_mesh(torch.cuda.device_count() + value)
        return
    options = {field: value}
    if field in ("use_local_energy", "checkpoint_dir"):
        options = {"use_local_energy": False,
                   "checkpoint_dir": str(tmp_path / value if field ==
                                         "checkpoint_dir" else tmp_path)}
    cfg = ppipe.PipelineConfig(verbose=False, **options)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ppipe.FlowGuidedKrylovPipeline(h, cfg)


def test_unported_branches_raise(tmp_path):
    from flow_guided_krylov_torch.flows import DiscreteFlowSampler
    from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
    from flow_guided_krylov_torch.utils.checkpoint import \
        CheckpointFormatError
    # spin Hamiltonians are ported: TFIM builds with the discrete flow
    tfim = ppipe.FlowGuidedKrylovPipeline(
        TransverseFieldIsing(6, h=0.5, device="cpu"),
        ppipe.PipelineConfig(verbose=False))
    assert isinstance(tfim.flow, DiscreteFlowSampler)
    assert tfim.n_valid == 64 and not tfim.is_molecular
    # resume is ported, but a stage the JAX package wrote is refused
    h = pmol.create_h2_hamiltonian("cpu")
    (tmp_path / "stage2").mkdir()
    (tmp_path / "stage2" / "FORMAT").write_text("orbax")
    with pytest.raises(CheckpointFormatError, match="JAX package"):
        ppipe.FlowGuidedKrylovPipeline(
            h, ppipe.PipelineConfig(verbose=False,
                                    checkpoint_dir=str(tmp_path))
        ).run(resume=True)
    # a 14-orbital (7a, 7b) space, 11.8M determinants: stage 4 no longer
    # raises but evolves in the restricted subspace (here capped at 300
    # states; HF is both the start and the basis and counts once: 299)
    big = pmol.MolecularHamiltonian(pmol.synthetic_integrals(14, 7, 7),
                                    device="cpu")
    pipe = ppipe.FlowGuidedKrylovPipeline(
        big, ppipe.PipelineConfig(verbose=False, max_krylov_dim=3,
                                  shots_per_krylov=5000))
    pipe._supported_evolution_dim = lambda: 300
    hf = big.get_hf_state()[None, :]
    e_hf = float(big.diagonal_np(hf)[0])
    pipe.nf_basis = hf
    pipe.results["stage3"] = {"energy": e_hf, "basis": hf}
    out = pipe.run_skqd()
    assert not out["skipped"] and out["restricted_dim"] == 299
    assert out["final_energy"] < e_hf
