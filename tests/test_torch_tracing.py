"""The port's tracer (``flow_guided_krylov_torch/utils/profiling.py``) on
the SKQD solve, on the CPU: TFIM-12 through the Trotter path.

* With recording off (no ``torch.profiler`` session) a whole solve
  opens no ``record_function``, synchronizes nothing and records
  nothing, and the host ``eigsh`` gets the projected H itself.
* Under the profiler one solve records its spans, each rooted at
  ``skqd.run`` and each a range among the profiler's events; the
  ``eigsh`` matvec counter matches an independent count.
* Recording leaves the arithmetic alone: energy, basis and draws are
  bit-identical on and off.
"""

import json
import os
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg
import torch
from torch.profiler import ProfilerActivity, profile

from flow_guided_krylov_torch.examples.skqd_lattice_validation import \
    run_pure_skqd
from flow_guided_krylov_torch.flows.physics_guided_training import \
    PhysicsGuidedFlowTrainer
from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
from flow_guided_krylov_torch.hamiltonians.spin import pack_spin_state
from flow_guided_krylov_torch.krylov.skqd import (
    SampleBasedKrylovDiagonalization, SKQDConfig)
from flow_guided_krylov_torch.utils import profiling

N, K, SHOTS = 12, 6, 2000
SKQD_SPANS = {"skqd.run": 1, "skqd.sample": K, "skqd.evolve": K - 1,
              "skqd.trotter_build": 1, "skqd.basis": 1, "skqd.project": 1}


def _tfim():
    return TransverseFieldIsing(N, V=1.0, h=0.5, periodic=True, device="cpu")


def _solve(seed=3):
    return run_pure_skqd(_tfim(), pack_spin_state(0, N), K, SHOTS,
                         seed=seed, evolution="trotter", final_only=True)


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _profiled(fn, *args, **kw):
    """fn(*args, **kw) under ``torch.profiler`` (CPU activity): its
    result and the names of the profiler's user ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    return out, names


def _raise(*args, **kw):
    raise AssertionError("called with recording off")


def test_recording_off_opens_no_range_and_records_nothing():
    assert not profiling.recording()
    with mock.patch.object(torch.profiler, "record_function", _raise), \
            mock.patch.object(torch.cuda, "synchronize", _raise):
        out = _solve()
        profiling.count("eigsh.matvecs", 5)
    assert np.isfinite(out["energy"])
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert profiling.records() == []


def test_profiled_solve_records_each_phase_once_a_step():
    _, names = _profiled(_solve)
    snap = profiling.snapshot()["spans"]
    assert {k: v["calls"] for k, v in snap.items()} == SKQD_SPANS
    for name, s in snap.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
    assert set(SKQD_SPANS) <= names
    recs = profiling.records()
    (root,) = [r for r in recs if r.name == "skqd.run"]
    assert root.parent is None
    assert all(r.root == root.id and r.end_ns >= r.start_ns for r in recs)
    # the first evolve builds the substep; later ones reuse it
    build = next(r for r in recs if r.name == "skqd.trotter_build")
    first = next(r for r in recs if r.name == "skqd.evolve")
    assert build.parent == first.id
    assert not profiling.recording()


def _run(seed):
    s = SampleBasedKrylovDiagonalization(
        _tfim(), SKQDConfig(max_krylov_dim=K, shots_per_krylov=SHOTS,
                            seed=seed, evolution="trotter"),
        initial_state=pack_spin_state(0, N))
    return s.run(final_only=True)


@pytest.mark.parametrize("seed", [0, 3])
def test_recording_leaves_the_solve_bit_identical(seed):
    off = _run(seed)
    on, _ = _profiled(_run, seed)
    assert on["final_energy"] == off["final_energy"]
    assert on["basis_sizes"] == off["basis_sizes"]
    np.testing.assert_array_equal(on["bases"][-1], off["bases"][-1])
    assert on["samples"] == off["samples"]
    assert len(on["samples"]) == K


def _fixed_v0_eigsh(seen):
    """SciPy's ``eigsh`` with a fixed start where the caller gives none
    (an unseeded start is drawn afresh every call), noting what it got."""
    real = scipy.sparse.linalg.eigsh

    def seeded(A, **kw):
        if kw.get("v0") is None:
            kw["v0"] = np.random.default_rng(7).uniform(-1, 1, A.shape[0])
        seen.append((A, kw["v0"]))
        return real(A, **kw)
    return real, seeded


def _independent_matvecs(real, M, k, v0):
    calls = [0]

    def mv(x):
        calls[0] += 1
        return M @ x

    op = scipy.sparse.linalg.LinearOperator(M.shape, matvec=mv,
                                            dtype=M.dtype)
    vals = real(op, k=k, which="SA", v0=v0, return_eigenvectors=False)
    return calls[0], np.sort(vals)


def test_projected_eigsh_counts_its_matvecs():
    """A 2,500-state basis takes ``compute_ground_state_energy``'s sparse
    branch: untraced, ``eigsh`` gets the matrix itself; traced, a
    counting operator, with the same energy to the bit and as many
    matvecs as an independent operator counts on the same matrix."""
    s = SampleBasedKrylovDiagonalization(
        _tfim(), SKQDConfig(evolution="trotter"),
        initial_state=pack_spin_state(0, N))
    basis = np.arange(2500, dtype=np.uint32)[:, None]
    seen = []
    real, seeded = _fixed_v0_eigsh(seen)
    with mock.patch.object(scipy.sparse.linalg, "eigsh", seeded):
        e_off = s.compute_ground_state_energy(basis)
        e_on, _ = _profiled(s.compute_ground_state_energy, basis)
    assert sp.issparse(seen[0][0])
    assert isinstance(seen[1][0], scipy.sparse.linalg.LinearOperator)
    assert not sp.issparse(seen[1][0])
    assert e_on == e_off
    snap = profiling.snapshot()
    assert snap["spans"]["eigsh"]["calls"] == 1
    assert snap["spans"]["skqd.project"]["calls"] == 1
    reg = s.config.regularization
    M = s.h.to_sparse(basis)
    M = (M + M.T) * 0.5 + reg * sp.eye(len(basis))
    calls, vals = _independent_matvecs(real, M, 1, seen[1][1])
    assert snap["counters"]["eigsh.matvecs"] == calls > 0
    assert abs(vals[0] - reg - e_on) < 1e-10
    assert 0 < snap["counters"]["eigsh.matvec_s"] <= (
        snap["spans"]["eigsh"]["total_s"])


def test_stage1_diagnostic_spans_its_eigsh():
    """``_accumulated_energy`` on 2,500 states: ``exact_ground_state``'s
    ``eigsh`` shows inside ``stage1.accumulated_energy``, matvecs
    counted, the energy that of the untraced call."""
    basis = np.arange(2500, dtype=np.uint32)[:, None]
    trainer = SimpleNamespace(h=_tfim(), accumulated_basis=basis)
    seen = []
    real, seeded = _fixed_v0_eigsh(seen)
    with mock.patch.object(scipy.sparse.linalg, "eigsh", seeded):
        e_off = PhysicsGuidedFlowTrainer._accumulated_energy(trainer)
        e_on, names = _profiled(
            PhysicsGuidedFlowTrainer._accumulated_energy, trainer)
    assert e_on == e_off
    assert {"stage1.accumulated_energy", "eigsh"} <= names
    recs = profiling.records()
    outer, inner = recs
    assert (outer.name, inner.name) == ("stage1.accumulated_energy", "eigsh")
    assert inner.parent == outer.id == inner.root
    M = trainer.h.to_sparse(basis)
    calls, _ = _independent_matvecs(real, (M + M.T) * 0.5, 1, seen[1][1])
    assert profiling.snapshot()["counters"]["eigsh.matvecs"] == calls


def test_nested_spans_and_counters():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            for _ in range(3):
                with profiling.span("inner"):
                    profiling.count("n")
            profiling.count("n", 2)
    snap = profiling.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert (outer["calls"], inner["calls"]) == (1, 3)
    assert inner["self_s"] == pytest.approx(inner["total_s"])
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"])
    assert snap["counters"] == {"n": 5}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_stage_timer_keeps_its_summary_and_traces_its_spans():
    off = profiling.StageTimer()
    with off.span("stage1_train"):
        pass
    with off.span("stage1_train"):
        pass
    assert profiling.snapshot()["spans"] == {}
    on = profiling.StageTimer()

    def stages():
        for name in ("stage1_train", "stage4_skqd", "stage4_skqd"):
            with on.span(name):
                torch.ones(8).sum()

    _, names = _profiled(stages)
    for timer, calls in ((off, {"stage1_train": 2}),
                         (on, {"stage1_train": 1, "stage4_skqd": 2})):
        summary = timer.summary()
        assert {k: v["calls"] for k, v in summary.items()} == calls
        for name, v in summary.items():
            assert set(v) == {"total_s", "calls", "mean_s"}
            assert v["total_s"] == round(timer.spans[name], 4)
            assert v["mean_s"] == round(timer.spans[name] / calls[name], 4)
    assert {"stage1_train", "stage4_skqd"} <= names
    spans = profiling.snapshot()["spans"]
    assert spans["stage4_skqd"]["calls"] == 2
    assert not hasattr(profiling.StageTimer, "dump")


def test_trace_writes_spans_beside_the_trace(tmp_path):
    profiling.count("left over")           # off: nothing to clear
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    log = tmp_path / "tr"
    with profiling.trace(str(log)):
        with profiling.span("inside"):
            profiling.count("things", 2)
    assert os.path.getsize(log / "trace.json") > 0
    spans = json.loads((log / "spans.json").read_text())
    assert set(spans["spans"]) == {"inside"}
    assert spans["counters"] == {"things": 2}
    assert spans == profiling.snapshot()


# -- restricted SKQD through the ELL route (the CLI's sci+skqd) -----------

H2O_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "perfbench", "tests", "data", "h2o-sto3g.integrals.npz")
RESTRICTED_SPANS = {"residual.pt2": 1, "skqd.restrict": 1,
                    "skqd.ell_build": 1, "skqd.evolve": K - 1,
                    "skqd.sample": K}


def _h2o():
    from flow_guided_krylov_torch.chem.scf import MolecularIntegrals
    from flow_guided_krylov_torch.hamiltonians.molecular import \
        MolecularHamiltonian
    with np.load(H2O_NPZ) as z:
        ints = MolecularIntegrals(
            h1e=z["h1e"], h2e=z["h2e"],
            nuclear_repulsion=float(z["nuclear_repulsion"]), n_electrons=10,
            n_orbitals=7, n_alpha=5, n_beta=5)
    return MolecularHamiltonian(ints, "cpu")


def _sci_skqd(seed=2):
    """One SCI round, its exact dE2 and restricted SKQD, as the CLI's
    ``--mode sci+skqd`` runs them, the ELL route taken (past the dense
    cap); the ELL products and the dE2 results are noted."""
    from flow_guided_krylov_torch.examples import \
        large_system_benchmark as lsb
    from flow_guided_krylov_torch.krylov.residual_expansion import \
        SelectedCIExpander
    from flow_guided_krylov_torch.ops import ell_spmv as ell_mod
    h = _h2o()
    products, pt2 = [], []
    plain = ell_mod.ell_spmv_reference
    correct = SelectedCIExpander.pt2_correction

    def counted(*args, **kw):
        products.append(args[3].shape)
        return plain(*args, **kw)

    def noted(self, *args, **kw):
        pt2.append(correct(self, *args, **kw))
        return pt2[-1]

    with mock.patch.object(SampleBasedKrylovDiagonalization,
                           "_dense_evolution_cap", lambda self: 0), \
            mock.patch.object(ell_mod, "ell_spmv_reference", counted), \
            mock.patch.object(SelectedCIExpander, "pt2_correction", noted):
        sci = lsb.run_sci(h, None, iters=1)
        out = lsb.run_restricted_skqd(h, None, sci.pop("_basis"),
                                      sci["final_energy"], krylov_dim=K,
                                      shots=SHOTS, seed=seed)
    out.pop("skqd_wall_s")
    return out, products, pt2, h


def test_restricted_solve_records_nothing_with_recording_off():
    with mock.patch.object(torch.profiler, "record_function", _raise), \
            mock.patch.object(torch.cuda, "synchronize", _raise):
        out, products, _, _ = _sci_skqd()
    assert products and np.isfinite(out["skqd_energy"])
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_restricted_solve_records_its_spans_and_counters():
    off = _sci_skqd()[0]
    (on, products, pt2, h), names = _profiled(_sci_skqd)
    assert on == off
    snap = profiling.snapshot()
    assert {k: v["calls"] for k, v in snap["spans"].items()
            if k in RESTRICTED_SPANS} == RESTRICTED_SPANS
    assert set(RESTRICTED_SPANS) <= names
    recs = profiling.records()
    build = next(r for r in recs if r.name == "skqd.ell_build")
    first = next(r for r in recs if r.name == "skqd.evolve")
    assert build.parent == first.id
    dim = on["skqd_restricted_dim"]
    c = snap["counters"]
    # one ELL product a Lanczos step, each a (2, N) [Re; Im] stack
    assert c["ell.launches"] == len(products) == (K - 1) * min(30, dim)
    assert c["ell.vectors"] == sum(p[0] for p in products) == 2 * len(
        products)
    assert c["ell.rows"] == dim
    assert c["ell.entries"] == dim * h.n_connections
    assert c["pt2.externals"] == pt2[0]["n_external"] > 0
    assert c["pt2.device"] == 1


# -- stage 1 on each local-energy route, and one SCI round ---------------

STAGE1_B, STAGE1_EPOCHS = 64, 3


def _stage1(route):
    """A short stage 1 on H2O/STO-3G (441 determinants, 140 connections
    a row) on ``route``: the trainer built (and its table with it) and
    trained for ``STAGE1_EPOCHS`` one-step epochs."""
    from flow_guided_krylov_torch.flows.particle_conserving import \
        ParticleConservingFlow
    from flow_guided_krylov_torch.flows.physics_guided_training import \
        PhysicsGuidedConfig
    from flow_guided_krylov_torch.models.dense import DenseNQS
    h = _h2o()
    cfg = PhysicsGuidedConfig(
        num_epochs=STAGE1_EPOCHS, min_epochs=STAGE1_EPOCHS,
        samples_per_batch=STAGE1_B, use_accumulated_energy=False,
        dense_local_energy_max_dim=0 if route == "table" else 20_000,
        use_connection_table=route != "fly", seed=4, verbose=False)
    trainer = PhysicsGuidedFlowTrainer(
        h, ParticleConservingFlow(7, 5, 5, (16, 16)),
        DenseNQS(14, (16, 16)), cfg)
    assert trainer.route == route
    return trainer.train()["energies"], h


@pytest.mark.parametrize("route", ["table", "dense", "fly"])
def test_stage1_records_its_spans_and_counters(route):
    """Each step's local energies are one ``stage1.local_energy`` span;
    the NQS rows counted are the shapes': B x C on ``table`` and ``fly``,
    N on ``dense``.  The table build is one synchronizing span, its rows
    and entries counted; recording leaves the energies bit-identical."""
    off, _ = _stage1(route)
    (on, h), names = _profiled(_stage1, route)
    assert on == off
    snap = profiling.snapshot()
    spans = {k: v["calls"] for k, v in snap["spans"].items()}
    c = snap["counters"]
    N, C = h.n_valid_configs, h.n_connections
    assert spans["stage1.local_energy"] == STAGE1_EPOCHS
    assert "stage1.local_energy" in names
    assert c["stage1.steps"] == STAGE1_EPOCHS
    rows = N if route == "dense" else STAGE1_B * C
    assert c["stage1.nqs_rows"] == STAGE1_EPOCHS * rows
    if route == "fly":
        assert "stage1.table_build" not in spans and "ctable.rows" not in c
    else:
        assert spans["stage1.table_build"] == 1
        assert (c["ctable.rows"], c["ctable.entries"]) == (N, N * C)


def _sci_round(device_scoring):
    from flow_guided_krylov_torch.krylov.residual_expansion import (
        ResidualExpansionConfig, SelectedCIExpander)
    h = _h2o()
    ex = SelectedCIExpander(h, ResidualExpansionConfig(
        configs_per_iteration=40, max_basis_size=441),
        use_device_scoring=device_scoring)
    out = ex.expand_basis(h.get_hf_state()[None, :])
    out = ex.expand_basis(out["basis"])
    return out["energy"], out["basis"]


@pytest.mark.parametrize("device_scoring", [True, False],
                         ids=["device", "host"])
def test_sci_rounds_record_their_scoring(device_scoring):
    """Two rounds: each scoring is one ``sci.score`` span and one
    ``sci.rounds``; ``sci.device_rounds`` counts those the device block
    scored."""
    e_off, b_off = _sci_round(device_scoring)
    (e_on, b_on), names = _profiled(_sci_round, device_scoring)
    assert e_on == e_off
    np.testing.assert_array_equal(b_on, b_off)
    snap = profiling.snapshot()
    assert snap["spans"]["sci.score"]["calls"] == 2
    assert "sci.score" in names
    c = snap["counters"]
    assert c["sci.rounds"] == 2
    assert c.get("sci.device_rounds", 0) == (2 if device_scoring else 0)


def test_stage1_and_sci_record_nothing_with_recording_off():
    with mock.patch.object(torch.profiler, "record_function", _raise), \
            mock.patch.object(torch.cuda, "synchronize", _raise):
        energies, _ = _stage1("table")
        e, _ = _sci_round(True)
    assert len(energies) == STAGE1_EPOCHS and np.isfinite(e)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
