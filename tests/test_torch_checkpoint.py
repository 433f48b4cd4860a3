"""Port parity: checkpoints and stage resume (``utils/checkpoint.py``, the
pipeline's ``checkpoint_dir`` and ``run(resume=True)``), and the other
knobs that came with them (``SKQDConfig.use_device_evolution`` /
``use_cumulative_basis``, ``utils/profiling``'s ``trace`` and
``device_memory_stats``), against the JAX package on the CPU."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu import pipeline as jpipe
from flow_guided_krylov_tpu import utils as jutils
from flow_guided_krylov_tpu.flows import training as jtr
from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_torch import pipeline as ppipe
from flow_guided_krylov_torch import utils as putils
from flow_guided_krylov_torch.flows import particle_conserving as ppc
from flow_guided_krylov_torch.flows import physics_guided_training as ppg
from flow_guided_krylov_torch.flows import training as ptr
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import skqd as pskqd
from flow_guided_krylov_torch.models import dense as pdense
from flow_guided_krylov_torch.utils import checkpoint as pck

torch.set_num_threads(1)

# the JAX resume test's flags (tests/test_pipeline.py::test_pipeline_resume)
RESUME_KW = dict(max_epochs=50, min_epochs=20, samples_per_batch=128,
                 nqs_hidden_dims=[32, 32], nf_hidden_dims=[32, 32],
                 verbose=False, max_krylov_dim=2, shots_per_krylov=2000)
# a resumed run recomputes nothing it restores: final energies equal to
# the JAX test's 1e-8
RESUME_ATOL = 1e-8


@pytest.fixture(autouse=True)
def _integral_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path / "integrals"))


def test_checkpoint_roundtrip_matches_jax(tmp_path):
    """The JAX test's state (plus uint32 words and a tensor) through both
    packages' save/load: the same values."""
    state = {"a": np.arange(5), "nested": {"b": np.eye(3)}, "scalar": 3.5,
             "words": np.array([[3, 0xFFFFFFFF]], np.uint32)}
    want = jutils.load_checkpoint(
        jutils.save_checkpoint(str(tmp_path / "jax"), state))
    got = pck.load_checkpoint(pck.save_checkpoint(
        str(tmp_path / "port"), dict(state, t=torch.arange(3.0))))
    for key in ("a", "words"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(got["nested"]["b"].numpy(),
                                  np.asarray(want["nested"]["b"]))
    assert got["scalar"] == float(want["scalar"]) == 3.5
    assert torch.equal(got["t"], torch.arange(3.0))
    with open(tmp_path / "port" / "FORMAT") as f:
        assert f.read() == pck.FORMAT_TAG
    with pytest.raises(TypeError, match="object"):
        pck.save_checkpoint(str(tmp_path / "bad"), {"x": object()})


def test_jax_written_checkpoints_are_refused(tmp_path):
    """A directory the JAX package wrote (``orbax``, or ``pickle`` where
    Orbax is missing) is refused by name, never unpickled; through the
    manager and through ``run(resume=True)`` too."""
    jdir = jutils.save_checkpoint(str(tmp_path / "ck" / "stage2"),
                                  {"nf_basis": np.zeros((3, 2), np.uint32)})
    pdir = tmp_path / "pickled"
    pdir.mkdir()
    (pdir / "FORMAT").write_text("pickle")
    (pdir / "state.pkl").write_bytes(pickle.dumps({"x": 1}))
    for path in (jdir, str(pdir)):
        with pytest.raises(pck.CheckpointFormatError,
                           match="written by the JAX package"):
            pck.load_checkpoint(path)
    with pytest.raises(pck.CheckpointFormatError, match="not a checkpoint"):
        pck.load_checkpoint(str(tmp_path))
    h = pmol.create_h2_hamiltonian("cpu")
    pipe = ppipe.FlowGuidedKrylovPipeline(h, ppipe.PipelineConfig(
        checkpoint_dir=str(tmp_path / "ck"), **RESUME_KW))
    with pytest.raises(pck.CheckpointFormatError):
        pipe.run(resume=True)


def _stage1_trainer(kind, seed):
    cfg = ppg.PhysicsGuidedConfig(num_epochs=3, min_epochs=1,
                                  samples_per_batch=64, verbose=False,
                                  use_accumulated_energy=False, seed=seed)
    if kind == "spin":
        from flow_guided_krylov_torch.flows import SpinFlowTrainer
        from flow_guided_krylov_torch.hamiltonians import \
            HeisenbergHamiltonian
        h = HeisenbergHamiltonian(8, 1.0, 1.0, 1.0, device="cpu")
        return SpinFlowTrainer(h, ppc.SzConservingFlow(8, 4),
                               pdense.DenseNQS(8, (16,)), cfg)
    return ppg.PhysicsGuidedFlowTrainer(
        pmol.create_lih_hamiltonian("cpu"),
        ppc.ParticleConservingFlow(6, 2, 2, (32, 32)),
        pdense.DenseNQS(12, (32, 32)), cfg)


@pytest.mark.parametrize("kind", ["molecular", "spin"])
def test_restore_trainer_roundtrip(tmp_path, kind):
    """save_trainer -> restore_trainer into a fresh trainer of another
    seed (the JAX test's steps), for both stage-1 trainers the pipeline
    checkpoints: params, both Adam states, basis and its keys, generator,
    history and EMA; the next step is then bit for bit the source's."""
    src = _stage1_trainer(kind, seed=1)
    src.train()
    ck = pck.CheckpointManager(str(tmp_path))
    ck.save_trainer("stage1", src)
    dst = _stage1_trainer(kind, seed=99)
    assert ck.restore_trainer("stage1", dst)
    assert not ck.restore_trainer("stage9", dst)
    np.testing.assert_array_equal(dst.accumulated_basis,
                                  src.accumulated_basis)
    if kind == "spin":
        np.testing.assert_array_equal(dst._acc_keys, src._acc_keys)
        assert dst._acc_keys.dtype == src._acc_keys.dtype
    else:
        assert torch.equal(dst._acc_keys, src._acc_keys)
        assert dst._acc_count == src._acc_count
    for a, b in ((src.flow, dst.flow), (src.nqs, dst.nqs)):
        for (name, x), (_, y) in zip(a.state_dict().items(),
                                     b.state_dict().items()):
            assert torch.equal(x, y), name
    for a, b in ((src.flow_opt, dst.flow_opt), (src.nqs_opt, dst.nqs_opt)):
        assert a.count == b.count == 3
        for x, y in zip(a.mu + a.nu, b.mu + b.nu):
            assert torch.equal(x, y)
    # empty histories are not saved, as in the JAX package
    def filled(history):
        return {k: v for k, v in history.items() if v}
    assert filled(dst.history) == filled(src.history)
    assert dst.energy_ema == src.energy_ema
    if kind == "spin":
        assert dst.step() == src.step()
        np.testing.assert_array_equal(dst.accumulated_basis,
                                      src.accumulated_basis)
    else:
        temp = src.temperature_at(3)
        assert torch.equal(dst.step(temp), src.step(temp))


def _flow_nqs_trainer(h, seed=0, **kw):
    cfg = ptr.TrainingConfig(samples_per_batch=64, seed=seed, verbose=False,
                             **kw)
    return ptr.FlowNQSTrainer(h, ppc.ParticleConservingFlow(6, 2, 2, (16,)),
                              pdense.DenseNQS(12, (16,)), cfg)


def test_flow_nqs_trainer_checkpoint_roundtrip(tmp_path):
    """save_checkpoint -> load_checkpoint: params, basis and its H,
    generator (the next sample equal) and history; the optimizer states
    are not restored, in the JAX trainer either (ROADMAP.md, Queue 3)."""
    h = pmol.create_lih_hamiltonian("cpu")
    src = _flow_nqs_trainer(h, num_epochs=5, min_epochs=1)
    src.train()
    path = src.save_checkpoint(str(tmp_path / "ck"))
    dst = _flow_nqs_trainer(h, seed=7, num_epochs=1)
    dst.load_checkpoint(path)
    np.testing.assert_array_equal(dst.cache.basis, src.cache.basis)
    # rebuilt in one extend: each coupling read from the other side's
    # connections, and symmetrized (the JAX load rebuilds likewise)
    torch.testing.assert_close(dst.cache.H_device, src.cache.H_device,
                               rtol=0, atol=1e-6 * 8.0)
    np.testing.assert_array_equal(dst.dedup.keys, src.dedup.keys)
    for a, b in ((src.flow, dst.flow), (src.nqs, dst.nqs)):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(x, y)
    assert dst.history == src.history
    assert src.nqs_opt.count == 5 and dst.nqs_opt.count == 0
    dst._sample_and_accumulate()
    src._sample_and_accumulate()
    np.testing.assert_array_equal(dst.cache.basis, src.cache.basis)

    # the JAX trainer's load leaves its Adam state at init likewise
    jh = jmol.create_lih_hamiltonian()
    from flow_guided_krylov_tpu.flows import ParticleConservingFlow
    from flow_guided_krylov_tpu.models import DenseNQS
    make = lambda: jtr.FlowNQSTrainer(  # noqa: E731
        jh, ParticleConservingFlow(n_orbitals=6, n_alpha=2, n_beta=2,
                                   hidden_dims=(16,)),
        DenseNQS(num_sites=12, hidden_dims=(16,)),
        jtr.TrainingConfig(num_epochs=3, min_epochs=1, samples_per_batch=64))
    jsrc = make()
    jsrc.train()
    jsrc.save_checkpoint(str(tmp_path / "jck"))
    jdst = make()
    jdst.load_checkpoint(str(tmp_path / "jck"))
    assert int(jsrc.nqs_opt_state[1][0].count) == 3
    assert int(jdst.nqs_opt_state[1][0].count) == 0


def test_pipeline_resume_matches_first_run(tmp_path):
    """The JAX test on the port: run, then run(resume=True) from the
    files; stages 1-3 resumed, the final energy equal to 1e-8, the JAX
    resumed records' keys."""
    h = pmol.create_h2_hamiltonian("cpu")
    kw = dict(RESUME_KW, checkpoint_dir=str(tmp_path / "port"))
    p1 = ppipe.FlowGuidedKrylovPipeline(h, ppipe.PipelineConfig(**kw),
                                        exact_energy=h.fci_energy())
    out1 = p1.run()
    assert sorted(os.listdir(tmp_path / "port")) == ["stage1", "stage2",
                                                     "stage3"]
    p2 = ppipe.FlowGuidedKrylovPipeline(h, ppipe.PipelineConfig(**kw),
                                        exact_energy=h.fci_energy())
    out2 = p2.run(resume=True)
    for stage in ("stage1", "stage2", "stage3"):
        assert p2.results[stage].get("resumed") is True, stage
    assert out2["chemical_accuracy"]
    assert out2["final_energy"] == pytest.approx(out1["final_energy"],
                                                 abs=RESUME_ATOL)
    assert p2.results["stage3"]["energy"] == p1.results["stage3"]["energy"]
    np.testing.assert_array_equal(p2.nf_basis, p1.nf_basis)

    jh = jmol.create_h2_hamiltonian()
    jkw = dict(RESUME_KW, checkpoint_dir=str(tmp_path / "jax"))
    jpipe.FlowGuidedKrylovPipeline(jh, jpipe.PipelineConfig(**jkw),
                                   exact_energy=jh.fci_energy()).run()
    j2 = jpipe.FlowGuidedKrylovPipeline(jh, jpipe.PipelineConfig(**jkw),
                                        exact_energy=jh.fci_energy())
    jout = j2.run(resume=True)
    assert sorted(out2) == sorted(jout)
    for stage in ("stage1", "stage2", "stage3", "stage4"):
        assert sorted(p2.results[stage]) == sorted(j2.results[stage]), stage


def test_subspace_energy_with_checkpoints_raises_the_reference_fault(
        tmp_path):
    """The JAX package fails on this combination (its save_trainer reads
    ``_acc_keys``, which FlowNQSTrainer lacks); the port refuses it up
    front and names the failure."""
    kw = dict(RESUME_KW, max_epochs=3, min_epochs=1, use_local_energy=False,
              checkpoint_dir=str(tmp_path))
    jh = jmol.create_h2_hamiltonian()
    with pytest.raises(AttributeError, match="_acc_keys"):
        jpipe.FlowGuidedKrylovPipeline(jh, jpipe.PipelineConfig(**kw)).run()
    h = pmol.create_h2_hamiltonian("cpu")
    with pytest.raises(NotImplementedError, match="AttributeError.*_acc_keys"):
        ppipe.FlowGuidedKrylovPipeline(h, ppipe.PipelineConfig(**kw))
    # and the port's save_trainer fails on that trainer, adapted to stage
    # 2 as the pipeline adapts it, where the JAX one does
    trainer = _flow_nqs_trainer(pmol.create_lih_hamiltonian("cpu"),
                                num_epochs=1, min_epochs=0)
    trainer.train()
    trainer.accumulated_basis = trainer.cache.basis
    with pytest.raises(AttributeError, match="_acc_keys"):
        pck.CheckpointManager(str(tmp_path / "m")).save_trainer("s", trainer)


def test_use_device_evolution_false_is_the_scipy_route():
    """``use_device_evolution=False`` evolves with the host f64
    propagator whatever ``evolution`` says: the same vector as the JAX
    package's, and a run's energy equal to ``evolution='scipy'``'s.
    The configs agree but for the JAX package's ``num_eigenvalues``: the
    port's projected solve asks for the one pair it reads."""
    jcfg = dataclasses.asdict(jskqd.SKQDConfig())
    assert jcfg.pop("num_eigenvalues") == 2
    assert dataclasses.asdict(pskqd.SKQDConfig()) == jcfg
    jh = jmol.create_lih_hamiltonian()
    ph = pmol.MolecularHamiltonian(jh.integrals, "cpu")
    off = dict(use_device_evolution=False, evolution="dense")
    js = jskqd.SampleBasedKrylovDiagonalization(jh, jskqd.SKQDConfig(**off))
    ps = pskqd.SampleBasedKrylovDiagonalization(ph, pskqd.SKQDConfig(**off))
    psi = np.zeros(ps.dim, complex)
    psi[ps._index_of(ps.initial_state)[0]] = 1.0
    got = ps.evolve(psi)
    np.testing.assert_array_equal(got, ps._evolve_scipy(psi))
    np.testing.assert_allclose(got, js.evolve(psi), rtol=0, atol=1e-12)
    dense = pskqd.SampleBasedKrylovDiagonalization(
        ph, pskqd.SKQDConfig(evolution="dense")).evolve(psi)
    assert not np.array_equal(dense, got)
    cfg = dict(max_krylov_dim=3, shots_per_krylov=3000, seed=4)
    e_off = pskqd.SampleBasedKrylovDiagonalization(
        ph, pskqd.SKQDConfig(use_device_evolution=False, **cfg)).run()
    e_scipy = pskqd.SampleBasedKrylovDiagonalization(
        ph, pskqd.SKQDConfig(evolution="scipy", **cfg)).run()
    assert e_off["energies"] == e_scipy["energies"]


def test_profiling_trace_and_memory_stats(tmp_path):
    """``trace`` writes a Chrome trace of the block; without a card
    ``device_memory_stats`` is None (the JAX function's answer where the
    backend reports nothing); the JAX package's exports, less its
    compilation-cache and platform workarounds."""
    with putils.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    if not torch.cuda.is_available():
        assert putils.device_memory_stats() is None
    assert sorted(putils.__all__) == sorted(jutils.__all__)
