"""The cell ``n2-ccpvdz.sci-skqd`` at its small size on the CPU
(H2O/STO-3G, ``tests/data/h2o-sci-skqd.json``), through the whole
harness: sound, it is correct; with each planted fault, or with the
control in the program's place, it is not; traced, it reads its
per-layer metrics from the program's spans and counters.  The ELL route
is taken as on the card, past the dense cap.  Beside them, the plain
reference ``reference/restricted.py`` against ``reference/slater.py``,
SciPy's matrix exponential and a brute-force dE2."""

from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import scipy.linalg
import torch

from perfbench import program_trace, run, tracing
from perfbench.entries import sci_skqd
from perfbench.reference import restricted, slater
from perfbench.tests import small
from perfbench.tests.small import run_small

CELL = "n2-ccpvdz.sci-skqd"
NPZ = str(run.REPO / "perfbench/tests/data/h2o-sto3g.integrals.npz")
SPAN_METRICS = ("restrict_ms", "ell_build_ms", "ell_evolve_ms", "pt2_ms")


@pytest.fixture(autouse=True)
def _ell_route():
    from flow_guided_krylov_torch.krylov import skqd
    with mock.patch.object(skqd.SampleBasedKrylovDiagonalization,
                           "_dense_evolution_cap", lambda self: 0):
        yield


def test_small_configuration_is_registered():
    assert small.SMALL["n2-ccpvdz"].endswith("h2o-sci-skqd.json")
    spec = run.cell_spec(small.manifest(), CELL)
    assert {m["name"] for m in spec.per_layer} == set(SPAN_METRICS) | {
        "ell_roofline_pct"}
    assert {m["name"] for m in spec.end_to_end} == {"solve_s", "peak_gb",
                                                    "setup_s"}


def test_sound_run_is_correct():
    r = run_small(CELL)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert r["checks"]["problems"]["value"] == 0


@pytest.mark.parametrize("fault", sci_skqd.FAULTS)
def test_fault_is_not_correct(fault):
    r = run_small(CELL, fault=fault)
    assert not r["correct"], (fault, r["checks"])


def test_control_is_not_correct():
    r = run_small(CELL, control=True)
    assert not r["correct"], r["checks"]
    c = r["checks"]
    for name in ("sci_energy_gap_ha", "de2_gap_ha", "state_gap",
                 "energy_gap_ha"):
        assert c[name]["value"] > c[name]["limit"], name


def test_traced_run_reads_the_program_spans():
    from flow_guided_krylov_torch.utils import profiling
    profiling.reset()
    traced = []
    solve = tracing.traced_solve

    def kept(*args):
        traced.append(solve(*args))
        return traced[-1]

    with mock.patch.object(tracing, "traced_solve", kept):
        r = run_small(CELL, trace=True)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in SPAN_METRICS:
        assert m[name] > 0, name
    # no kernel runs on the CPU: the roofline has no device time to read
    assert "ell_roofline_pct" not in m
    c = profiling.snapshot()["counters"]
    assert c["ell.launches"] == 5 * 30 and c["ell.vectors"] == 300
    assert c["ell.entries"] == c["ell.rows"] * 140
    assert traced[0].record["restricted_dim"] == c["ell.rows"]


def test_readers_return_nothing_without_the_program_counters():
    ctx = SimpleNamespace(trace=None)
    for name in SPAN_METRICS + ("ell_roofline_pct",):
        reader = run.load_module(run.HERE / "metrics" / f"{name}.py",
                                 f"perfbench_metric_{name}")
        assert reader.read(ctx) is None, name
    assert program_trace.ell_bytes({}) is None


def test_ell_bytes_counts_tables_diagonal_and_vectors():
    N, C, launches = 1000, 10, 3
    c = {"ell.launches": launches, "ell.rows": N, "ell.entries": N * C,
         "ell.vectors": 2 * launches}
    # elements and targets 4 bytes an entry, the diagonal 4 a row, two
    # vectors read and two written each launch
    want = launches * (N * C * 8 + N * 4 + 2 * N * 4 * 2)
    assert program_trace.ell_bytes(c) == want


# -- the reference ----------------------------------------------------------

def _h2o():
    h1, h2, e_nuc = slater.load_integrals(NPZ)
    return (h1, h2, e_nuc), restricted.Integrals(h1, h2, e_nuc, 5, 5)


def test_hamiltonian_is_slater_on_a_subset():
    (h1, h2, e_nuc), ints = _h2o()
    dets = slater.all_determinants(7, 5, 5)
    for sub in (dets, dets[::3], dets[7::5]):
        H, diag = restricted.hamiltonian(ints, sub)
        want = slater.projected_hamiltonian(sub, 7, 5, 5, h1, h2,
                                            e_nuc).toarray()
        got = H.to_dense().numpy()
        assert np.abs(got - want).max() < 1e-12
        assert np.abs(diag.numpy() - np.diag(want)).max() < 1e-12
    assert ints.n_connections == 140


def test_states_follow_the_exact_propagator():
    _, ints = _h2o()
    dets = slater.all_determinants(7, 5, 5)
    H, diag = restricted.hamiltonian(ints, dets)
    U = scipy.linalg.expm(-1j * 0.1 * H.to_dense().numpy())
    psi = np.zeros(len(dets), complex)
    psi[0] = 1.0
    for _, re, im in restricted.krylov_states(H, diag, 0, 3, 0.1):
        psi = U @ psi
        assert np.abs(re.numpy() + 1j * im.numpy() - psi).max() < 1e-11
    ctl = restricted.krylov_states(H, diag, 0, 2, 0.1, dtype=torch.bfloat16)
    psi = U @ np.eye(len(dets))[0]
    _, cre, cim = next(ctl)
    assert np.abs(cre.double().numpy() + 1j * cim.double().numpy()
                  - psi).max() > 1e-4


def test_pt2_is_the_brute_force_sum():
    (h1, h2, e_nuc), ints = _h2o()
    dets = slater.all_determinants(7, 5, 5)
    Hall = slater.projected_hamiltonian(dets, 7, 5, 5, h1, h2,
                                        e_nuc).toarray()
    pick = np.argsort(Hall.diagonal())[:40]
    Hb = Hall[np.ix_(pick, pick)]
    w, V = np.linalg.eigh(Hb)
    out = ~np.isin(np.arange(len(dets)), pick)
    coupling = Hall[np.ix_(out, pick)] @ V[:, 0]
    want = np.sum(coupling ** 2 / (w[0] - Hall.diagonal()[out]))
    got = restricted.pt2(ints, dets[pick], V[:, 0], w[0])
    assert abs(got["de2"] - want) < 1e-14
    ctl = restricted.pt2(ints, dets[pick], V[:, 0], w[0],
                         dtype=torch.bfloat16)
    assert abs(ctl["de2"] - want) > 1e-8


def test_excitation_rank():
    hf = np.array([0b11111, 0b11111])
    dets = np.array([[0b11111, 0b11111], [0b101111, 0b11111],
                     [0b1100111, 0b11111], [0b101111, 0b101111]])
    assert restricted.excitation_rank(dets, hf).tolist() == [0, 1, 2, 2]
