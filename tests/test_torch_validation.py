"""Port parity for the SKQD validation suite (``examples/skqd_validation.py``)
on the CPU, against the JAX package.

From one carried JAX stage-1 state on LiH/6-31G (3,025 determinants; the
JAX trainer for a few epochs, then ``convert.load_trainer_from_jax``, as
``tests/test_torch_headline.py`` does), the suite's algebra in both
packages: the flow-selected basis, the projected-H ground energies of SKQD
(``compute_ground_state_energy``) on it and on a merged basis,
``basis_overlap`` and ``merge_bases`` (``provenance``), the ``poor-init``
truncation as the two CLIs make it, and ``iterative_residual_expansion``
(``631g`` and ``headtohead``).  Then one ELL evolve over H2O/6-31G's whole
(1 frozen, 10 active) space, the plain version of the kernel on the CPU,
against the port's host float64 ``expm_multiply``; and
``chip_smoke.phase_validation``'s glue at small sizes.
"""

import contextlib
import importlib.util
import json
import os
from unittest import mock

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

import flow_guided_krylov_tpu.krylov as jkrylov
from flow_guided_krylov_tpu import pipeline as jpipe
from flow_guided_krylov_tpu.chem import compute_molecular_integrals as jax_mi
from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.krylov import SKQDConfig as JSKQDConfig
from flow_guided_krylov_tpu.krylov import \
    iterative_residual_expansion as jax_residual
from flow_guided_krylov_tpu.krylov.residual_expansion import \
    ResidualExpansionConfig as JResidualConfig
from flow_guided_krylov_tpu.postprocessing import utils as jutils
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch import pipeline as ppipe
from flow_guided_krylov_torch.chem import (compute_active_space_integrals,
                                           compute_molecular_integrals)
from flow_guided_krylov_torch.examples import skqd_validation as pval
from flow_guided_krylov_torch.flows import physics_guided_training as ppg
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.krylov import (
    FlowGuidedSKQD, ResidualExpansionConfig, SampleBasedKrylovDiagonalization,
    SKQDConfig, iterative_residual_expansion)
from flow_guided_krylov_torch.postprocessing import utils as putils

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f64 eigensolves of one basis by two packages
ENERGY_TOL = 1e-8
# the float32 ELL Lanczos propagator against scipy's f64 expm_multiply,
# relative 2-norm (the propagator's float32 tridiagonal eigh, F4)
EVOLVE_RTOL = 1e-5
LIH_631G = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.6))]
# five NQS layers keep the medium tier's widths from being raised to
# [384]*5; the stage-1 state is what is carried, its size is not the point
STAGE1 = dict(max_epochs=6, min_epochs=2, samples_per_batch=256,
              nqs_hidden_dims=[32] * 5, nf_hidden_dims=[32, 32], seed=3,
              verbose=False)
# the suite's SKQD settings (``run_isolated``, ``run_631g``)
SKQD = dict(max_krylov_dim=8, shots_per_krylov=50000)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The BLAS and OpenMP pools at one thread, as torch's: the suite runs
    this file beside others on every core, where idle pool threads that
    spin take the cores other workers need."""
    with threadpool_limits(limits=1):
        yield


class _Caught(Exception):
    pass


def _jax_script(name):
    """The JAX package's ``examples/<name>.py``, loaded without running
    its command line."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


@pytest.fixture(scope="module")
def lih631(tmp_path_factory):
    """Both pipelines on LiH/6-31G after stage 2, the port's from the JAX
    stage-1 state: (JAX pipeline, port pipeline)."""
    cache = str(tmp_path_factory.mktemp("integrals"))
    with mock.patch.dict(os.environ, {"FGK_INTEGRAL_CACHE": cache}):
        jh = jmol.MolecularHamiltonian(jax_mi(LIH_631G, basis="6-31g"))
        ph = pmol.MolecularHamiltonian(jh.integrals, "cpu")
        assert ph.n_valid_configs == jh.n_valid_configs == 3025
        jp = jpipe.FlowGuidedKrylovPipeline(
            jh, jpipe.PipelineConfig(**STAGE1), exact_energy=None)
        pp = ppipe.FlowGuidedKrylovPipeline(
            ph, ppipe.PipelineConfig(**STAGE1), exact_energy=None)
        jp.train_flow_nqs()
        c = pp.config
        pp.trainer = ppg.PhysicsGuidedFlowTrainer(
            ph, pp.flow, pp.nqs, ppg.PhysicsGuidedConfig(
                samples_per_batch=c.samples_per_batch,
                max_accumulated_basis=c.max_accumulated_basis,
                verbose=False))
        convert.load_trainer_from_jax(pp.trainer, jp.trainer)
        jp.extract_and_select_basis()
        pp.extract_and_select_basis()
        yield jp, pp


def test_nf_basis_and_its_energies_match_jax(lih631):
    """The flow-selected basis bit for bit, and SKQD's projected ground
    energy of it and of its union with a seeded sample of the space, with
    ``merge_bases`` and ``basis_overlap`` equal (``provenance``)."""
    jp, pp = lih631
    assert len(pp.nf_basis) > 10
    np.testing.assert_array_equal(pp.nf_basis, jp.nf_basis)
    np.testing.assert_array_equal(pp.h.keys(pp.nf_basis),
                                  jp.h.keys(jp.nf_basis))
    jskqd = jkrylov.FlowGuidedSKQD(jp.h, jp.nf_basis, JSKQDConfig(**SKQD))
    pskqd = FlowGuidedSKQD(pp.h, pp.nf_basis, SKQDConfig(**SKQD))
    e_nf = pskqd.compute_ground_state_energy(pp.nf_basis)
    assert e_nf == pytest.approx(
        jskqd.compute_ground_state_energy(jp.nf_basis), abs=ENERGY_TOL)

    space = pp.h.enumerate_basis()
    rng = np.random.default_rng(14)
    other = space[np.sort(rng.choice(len(space), 400, replace=False))]
    merged = putils.merge_bases(pp.nf_basis, other)
    np.testing.assert_array_equal(merged,
                                  jutils.merge_bases(jp.nf_basis, other))
    overlap = putils.basis_overlap(pp.nf_basis, other, keys_fn=pp.h.keys)
    assert overlap == jutils.basis_overlap(jp.nf_basis, other,
                                           keys_fn=jp.h.keys)
    assert overlap["n_common"] + overlap["n_b_only"] == 400
    assert len(merged) == overlap["n_a"] + overlap["n_b_only"]
    e_merged = pskqd.compute_ground_state_energy(merged)
    assert e_merged == pytest.approx(
        jskqd.compute_ground_state_energy(merged), abs=ENERGY_TOL)
    assert e_merged <= e_nf + ENERGY_TOL


def test_poor_init_truncation_matches_jax(lih631):
    """Both CLIs' ``run_poor_init`` on the carried pipeline: the basis
    each hands to ``FlowGuidedSKQD`` after its lowest-diagonal truncation
    holds the same rows in the same order."""
    jp, pp = lih631
    script = _jax_script("skqd_validation")

    def caught(_, basis, *__, **___):
        raise _Caught(np.asarray(basis))

    bases = []
    for build_owner, skqd_owner, h, pipe, call in (
            (script, jkrylov, jp.h, jp, lambda: script.run_poor_init("lih")),
            (pval, pval, pp.h, pp,
             lambda: pval.run_poor_init("lih", device="cpu"))):
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                build_owner, "build", lambda *_, h=h, **__: h))
            stack.enter_context(mock.patch.object(
                build_owner, "train_nf", lambda *_, p=pipe, **__: p))
            stack.enter_context(mock.patch.object(
                skqd_owner, "FlowGuidedSKQD", caught))
            stack.enter_context(mock.patch.object(h, "fci_energy",
                                                  lambda: 0.0))
            with pytest.raises(_Caught) as got:
                call()
        bases.append(got.value.args[0])
    jax_basis, port_basis = bases
    assert len(port_basis) == max(10, int(0.55 * len(pp.nf_basis)))
    np.testing.assert_array_equal(port_basis, jax_basis)


def test_residual_expansion_matches_jax(lih631):
    """``iterative_residual_expansion`` from the flow basis, as ``631g``
    and ``headtohead`` call it, at three rounds: the same rounds, the
    same final basis and every energy to 1e-8 Ha."""
    jp, pp = lih631
    mine = iterative_residual_expansion(
        pp.h, pp.nf_basis, ResidualExpansionConfig(max_iterations=3))
    ref = jax_residual(jp.h, jp.nf_basis, JResidualConfig(max_iterations=3))
    assert mine["n_iterations"] == ref["n_iterations"] >= 1
    assert len(mine["basis"]) == len(ref["basis"]) > len(pp.nf_basis)
    np.testing.assert_array_equal(np.sort(pp.h.keys(mine["basis"])),
                                  np.sort(jp.h.keys(ref["basis"])))
    np.testing.assert_allclose(mine["energies"], ref["energies"], rtol=0,
                               atol=ENERGY_TOL)
    assert mine["energy"] == pytest.approx(ref["energy"], abs=ENERGY_TOL)


def test_h2o_631g_ell_evolve_matches_scipy(tmp_path, monkeypatch):
    """One evolve of H2O/6-31G's whole (1, 10) window (44,100 determinants,
    804 connections) from HF, as ``631g --molecule h2o``'s SKQD takes it
    (past the dense cap): ``evolution="ell"`` forced, the kernel's plain
    version on the CPU, against the host float64 ``evolution="scipy"``."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    ang = np.radians(104.5)
    geom = [("O", (0, 0, 0)), ("H", (0.96, 0, 0)),
            ("H", (0.96 * np.cos(ang), 0.96 * np.sin(ang), 0))]
    h = pmol.MolecularHamiltonian(compute_active_space_integrals(
        compute_molecular_integrals(geom, basis="6-31g"), n_frozen=1,
        n_active=10), "cpu")
    ell = SampleBasedKrylovDiagonalization(h, SKQDConfig(evolution="ell"))
    host = SampleBasedKrylovDiagonalization(h, SKQDConfig(evolution="scipy"))
    assert (ell.dim, h.n_connections) == (44100, 804)
    assert ell.dim > ell._dense_evolution_cap()
    psi = np.zeros(ell.dim, np.complex128)
    psi[ell._index_of(ell.initial_state)[0]] = 1.0
    got = ell.evolve(psi)
    assert ell._ell is not None and host._ell is None
    ref = host.evolve(psi)
    gap = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert gap < EVOLVE_RTOL
    # the evolve moved the state: the test is not of the identity
    assert np.linalg.norm(ref - psi) > 0.1


# the keys of each line ``chip_smoke.phase_validation`` prints beside the
# CLI's own
VALIDATION_KEYS = {"n_valid", "record", "gap_to_record_mha", "wall_s",
                   "fci_s", "skqd_eigensolves", "ell_launches",
                   "peak_memory_bytes"}


def test_chip_smoke_validation_rehearsal(capsys, tmp_path, monkeypatch):
    """``chip_smoke.phase_validation``'s glue and checks without a card:
    ``--experiment all --molecule h2`` (its ``631g`` on LiH/6-31G), the
    records' other calls on H2 and LiH, and benzene's pi space through
    ``large_system_benchmark`` at a few epochs a pipeline."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.phase_validation(device="cpu", rehearsal=True)
    text = capsys.readouterr().out
    lines = [(ln.split(": ", 1)[0], json.loads(ln.split(": ", 1)[1]))
             for ln in text.splitlines()
             if ln.startswith(("validation ", "frontier "))]
    names = [name for name, _ in lines]
    assert names[:7] == [f"validation {e} {m}" for e, m in (
        ("631g", "lih"), ("headtohead", "h2"), ("isolated", "h2"),
        ("poor-init", "h2"), ("provenance", "h2"), ("stretched", "h2"),
        ("stretched-full", "h2"))]
    assert names[7:] == ["validation stretched lih",
                         "validation stretched h2",
                         "validation stretched-full lih",
                         "validation headtohead h2", "frontier benzene_pi"]
    for name, line in lines:
        assert VALIDATION_KEYS <= set(line), name
        assert line["ell_launches"] == 0 and line["peak_memory_bytes"] is None
        assert line["fci_s"] > 0 and line["wall_s"] > 0
    got = dict(lines)
    assert got == json.loads(json.dumps(res["lines"]))
    assert got["validation 631g lih"]["n_valid"] == 3025
    assert got["validation 631g lih"]["record"]["path"] == \
        "results/val_631g_lih.txt"
    assert got["validation 631g lih"]["skqd_eigensolves"]["count"] == 17
    assert got["validation stretched lih"]["stretch"] == 1.3
    assert got["validation stretched lih"]["n_valid"] == 225
    assert got["frontier benzene_pi"]["n_valid"] == 400
    for name in ("validation stretched-full lih", "frontier benzene_pi"):
        assert got[name]["pipeline"]["max_epochs"] == \
            smoke.REHEARSAL_EPOCHS, name
    assert res["launches"] is None and res["rows"] == []

    # a check that fails raises: NF+SKQD above NF alone, an error below
    # FCI, a record's space or chemical accuracy, on the CLI's own lines
    added = VALIDATION_KEYS - {"n_valid"} | {"pipeline"}
    cli = {name: {k: v for k, v in line.items() if k not in added}
           for name, line in got.items()}
    with pytest.raises(RuntimeError, match="NF\\+SKQD above NF"):
        smoke.check_validation("isolated h2", {
            **cli["validation isolated h2"], "nf_skqd_mha": 1.0}, None)
    with pytest.raises(RuntimeError, match="below FCI"):
        smoke.check_validation("headtohead h2", {
            **cli["validation headtohead h2"], "krylov_mha": -1e-3}, None)
    rec = smoke.VALIDATION_RECORD[("631g", "lih")]
    smoke.check_validation("631g lih", cli["validation 631g lih"], rec)
    with pytest.raises(RuntimeError, match="3025"):
        smoke.check_validation("631g lih", {**cli["validation 631g lih"],
                                            "n_valid": 3024}, rec)
    with pytest.raises(RuntimeError, match="not under"):
        smoke.check_validation("631g lih", {**cli["validation 631g lih"],
                                            "nf_mha": 2.0}, rec)
