"""Port parity for the spin-lattice frontier (``chip_smoke.py``'s
``phase_spin_frontier``) on the CPU, against the JAX package.

The frontier runs TFIM-28's Trotter SKQD (2^28 amplitudes through the
x_sweep kernel) and TFIM-25/26 full-space ED (the ELL kernel on the 2^25
and 2^26 identity tables) on a card.  Here, at sizes a CPU holds:

* the free-fermion energies the frontier is held to, bit-equal to the JAX
  CLI's and equal to the records' to 1e-12 Ha;
* the route and Lanczos depth the card takes at 2^25 and 2^26
  (``eigensolver._fullspace_plan``: arithmetic, nothing allocated);
* the gathered-tile plan of TFIM-28's Trotter words (taken from the
  port's substep builder, no state made), and at 16 sites the plan
  replayed through the plain version against the JAX package's rotation
  chain (its 32 half-angle rotations against the port's 16 full-angle
  ones);
* the full-space device stage at 2^16 on both routes against the JAX
  package's and the free-fermion energy;
* the phase's glue and checks at TFIM-12/14/16.

Tolerances: a sweep of 16 full-angle float32 rotations over
unit-variance amplitudes against the JAX package's 32 half-angle ones,
the port's cos and sin taken in float64 and rounded, the JAX rotation's in
float32, held to 1e-5 (the Trotter evolve's bound in
``tests/test_torch_trotter.py``; they differ by 2.9e-6); a float32
Lanczos against another package's float32 Lanczos and against the closed
form, 1e-5 Ha on ``ell-fused`` (fully reorthogonalized, as
``tests/test_torch_eigensolvers.py`` holds it) and ``EIGENSOLVER_TOL`` =
1e-3 Ha on ``flip-stepped`` (no reorthogonalization; the smoke's bound).
"""

import importlib.util
import json
import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov.basis_sampler import \
    _apply_pauli_rotation as jax_rotation
from flow_guided_krylov_tpu.krylov.basis_sampler import \
    _pauli_masks as jax_masks
from flow_guided_krylov_tpu.postprocessing import eigensolver as jeig
from flow_guided_krylov_tpu.utils import memory as jmemory
from flow_guided_krylov_torch.examples import skqd_lattice_validation as plat
from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
from flow_guided_krylov_torch.krylov import skqd
from flow_guided_krylov_torch.ops import x_sweep as xs
from flow_guided_krylov_torch.postprocessing import eigensolver as eig
from flow_guided_krylov_torch.utils import memory

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREE_FERMION_TOL = 1e-12
SWEEP_TOL = 1e-5
FUSED_TOL = 1e-5
STEPPED_TOL = 1e-3
# the records of the closed form: (sites, h) -> (file, key)
RECORDS = {(25, 1.0): ("results/val_tfim25_exactfull.txt", "oracle_energy"),
           (26, 1.0): ("results/val_tfim26_exactfull.txt", "oracle_energy"),
           (26, 0.5): ("results/val_lattice_tfim26.txt", "exact_energy"),
           (28, 0.5): ("results/val_lattice_tfim28.txt", "exact_energy")}
# the total memory an H100 80GB HBM3 reports (torch.cuda.mem_get_info;
# chip_smoke.py prints it as each full-space run's device_memory_bytes)
H100_BYTES = 85_017_493_504


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))


def _module(name, path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, path))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _jax_lattice_cli():
    return _module("jax_skqd_lattice_validation",
                   "examples/skqd_lattice_validation.py")


def _smoke():
    return _module("chip_smoke", "chip_smoke.py")


def _record(path, key):
    """``key`` of the last JSON line of a record that holds it."""
    with open(os.path.join(ROOT, path)) as f:
        lines = [json.loads(ln) for ln in f.read().splitlines()
                 if ln.startswith("{")]
    return [ln for ln in lines if key in ln][-1][key]


def _tfim(n, h=1.0):
    return TransverseFieldIsing(n, V=1.0, h=h, periodic=True, device="cpu")


# ---------------------------------------------------------------------------
# (a) the closed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [1.0, 0.5])
@pytest.mark.parametrize("n", [25, 26, 28])
def test_free_fermion_energy_matches_jax_and_records(n, h):
    e = plat.tfim_free_fermion_energy(n, 1.0, h)
    assert e == _jax_lattice_cli().tfim_free_fermion_energy(n, 1.0, h)
    assert e == _smoke().tfim_free_fermion_energy(n, 1.0, h)
    if (n, h) in RECORDS:
        assert abs(e - _record(*RECORDS[n, h])) <= FREE_FERMION_TOL


def test_smoke_frontier_records_are_the_files():
    """The numbers ``phase_spin_frontier`` prints beside its runs are the
    record files' own."""
    smoke = _smoke()
    study = smoke.SPIN_FRONTIER_STUDY
    with open(os.path.join(ROOT, study["path"])) as f:
        rows = [json.loads(ln) for ln in f.read().splitlines()
                if ln.startswith("{")]
    row = next(r for r in rows if (r["krylov_dim"], r["shots"], r["dt"])
               == study["point"])
    assert (row["n_spins"], row["h"]) == (study["sites"], study["h"])
    assert row["basis_size"] == study["basis_size"]
    assert row["error_mha"] == study["error_mha"]
    assert abs(study["exact"] - _record(*RECORDS[28, 0.5])) == 0.0
    for n, rec in smoke.SPIN_FRONTIER_FULLSPACE.items():
        assert rec["exact"] == _record(rec["path"], "oracle_energy")
        assert rec["error_mha"] == _record(rec["path"], "error_mha")
        assert rec["exact"] == _record(*RECORDS[n, 1.0])


# ---------------------------------------------------------------------------
# (b) the route and depth the card takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,restarts", [(25, 120, 1), (26, 66, 2)])
def test_fullspace_plan_on_the_card(n, m, restarts):
    """On the card's memory both identity tables fit (6.7 and 14.0 GB):
    ``ell-fused``, the Krylov block under 40 % of memory less the tables
    (at 2^26 it caps m, and restarts recover the depth); under the
    smoke's forced budget of six 2^n vectors, ``flip-stepped``.  The
    int32 targets and int64 offsets hold n * 2^n entries."""
    c = _tfim(10).n_connections
    assert c == 10                                # one flip a site
    assert eig._fullspace_plan(n, n, H100_BYTES) == {
        "route": "ell-fused", "lanczos_m": m, "restarts": restarts}
    assert eig._fullspace_plan(n, n, 64 * 4 << n) == {
        "route": "flip-stepped", "lanczos_m": 40, "restarts": 3}
    assert n * (1 << n) < 2 ** 31 - 1
    with pytest.raises(MemoryError):
        eig._fullspace_plan(n, n, 20 << n)


# ---------------------------------------------------------------------------
# (c) the Trotter plan
# ---------------------------------------------------------------------------

def _trotter_words(n, h=0.5):
    """The word list the port's Trotter substep hands to
    ``make_gathered_sweeps`` for TFIM-n, taken from ``_trotter_ops`` with
    the half phase and the sweeps stubbed: no 2^n state is made.  TFIM's
    off-diagonal words (one X a site) commute, so the list is each X once
    at its full angle, low-tile words first."""
    s = skqd.SampleBasedKrylovDiagonalization(
        _tfim(n, h), skqd.SKQDConfig(evolution="trotter"),
        initial_state=np.array([0], np.uint32))
    got = []
    with mock.patch.object(skqd, "_half_phase", lambda *a: (None, None)), \
            mock.patch.object(skqd, "make_gathered_sweeps",
                              lambda n, ws: got.append(list(ws))):
        s._trotter_ops()
    assert len(got) == 1
    return got[0]


def test_tfim28_trotter_plan_covers_every_word():
    """TFIM-28's 28 X words, each once at its full angle: three gathered
    tiles of 14, 10 and 4 words, every word in one of them once and in
    order, each tile's table one the kernel takes, so no word is left to
    a plain rotation."""
    n = 28
    words = _trotter_words(n)
    assert [w[1] for w in words] == [1 << q for q in range(n)]
    assert all(w[0] == -0.5 * 0.1 / 8 and w[2:] == (0, 0) for w in words)
    plan = xs.plan_sweeps(words, n)
    assert [w for _, ws in plan for w in ws] == words
    assert [len(ws) for _, ws in plan] == [14, 10, 4]
    low = tuple(range(4))
    assert [tile for tile, _ in plan] == [
        tuple(range(14)), low + tuple(range(14, 24)),
        tuple(range(10)) + tuple(range(24, 28))]
    for tile, ws in plan:
        mask = sum(1 << q for q in tile)
        assert len(tile) == xs.TILE_BITS
        assert all(w[1] & ~mask == 0 for w in ws)
        assert xs.sweep_table(ws, n, tile).shape == (len(ws), 8)
    # the cell's launch count: 15 evolves x 8 substeps x 3 tiles
    assert 15 * 8 * len(plan) == 360


def test_tfim16_plan_replay_matches_jax_rotation_chain():
    """The same planner at 16 sites: the port's 16 full-angle words in two
    tiles, run through the plain version, equal the JAX package's 32
    half-angle rotations (low, high, high reversed, low reversed) one by
    one: the same product in exact arithmetic."""
    n = 16
    words = _trotter_words(n)
    coeffs, paulis = jspin.extract_coeffs_and_paulis(
        jspin.TransverseFieldIsing(n, V=1.0, h=0.5))
    offd = [(c * 0.1 / 8 / 2,) + jax_masks(p) for c, p in zip(coeffs, paulis)
            if jax_masks(p)[0]]
    low = [w for w in offd if w[1] < 1 << xs.TILE_BITS]
    high = [w for w in offd if w[1] >= 1 << xs.TILE_BITS]
    assert words == [(2 * w[0],) + w[1:] for w in low + high]
    assert len(xs.plan_sweeps(words, n)) == 2
    rng = np.random.default_rng(5)
    re0 = rng.normal(size=1 << n).astype(np.float32)
    im0 = rng.normal(size=1 << n).astype(np.float32)
    pr, pi = xs.make_gathered_sweeps(n, words)(torch.as_tensor(re0),
                                               torch.as_tensor(im0))
    jr, ji = jnp.asarray(re0), jnp.asarray(im0)
    for theta, xm, zm, ny in low + high + high[::-1] + low[::-1]:
        jr, ji = jax_rotation(jr, ji, jnp.float32(theta), xm, zm, ny, n)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0,
                               atol=SWEEP_TOL)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0,
                               atol=SWEEP_TOL)


# ---------------------------------------------------------------------------
# (d) the full-space device stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,budget,tol", [
    ("ell-fused", 4 << 30, FUSED_TOL),
    ("flip-stepped", 64 * 4 << 16, STEPPED_TOL)])
def test_fullspace_device_stage_matches_jax(route, budget, tol,
                                            monkeypatch):
    """TFIM-16 at h = 1 through the device stage alone, memory picking
    the route in both packages: the route, depth and energy of the JAX
    package's, the free-fermion energy, and the plan the smoke reads."""
    n = 16
    monkeypatch.setattr(memory, "device_memory_bytes", lambda device: budget)
    monkeypatch.setattr(jmemory, "device_memory_bytes",
                        lambda device=None: budget)
    got = eig.exact_fullspace_ground_state(_tfim(n), refine_host=False,
                                           use_cache=False, verbose=False)
    want = jeig.exact_fullspace_ground_state(
        jspin.TransverseFieldIsing(n, V=1.0, h=1.0), refine_host=False,
        use_cache=False, verbose=False)
    assert got["route"] == want["route"] == route
    assert (got["lanczos_m"], got["restarts"]) == \
        (want["lanczos_m"], want["restarts"])
    assert eig._fullspace_plan(n, n, budget) == {
        k: got[k] for k in ("route", "lanczos_m", "restarts")}
    exact = plat.tfim_free_fermion_energy(n, 1.0, 1.0)
    assert got["energy"] == got["e_device"]
    assert abs(got["e_device"] - want["e_device"]) < tol
    assert abs(got["e_device"] - exact) < tol


# ---------------------------------------------------------------------------
# (e) the smoke's phase at small sizes
# ---------------------------------------------------------------------------

def test_chip_smoke_spin_frontier_rehearsal(capsys):
    """``phase_spin_frontier(device="cpu", rehearsal=True)``: the TFIM-12
    study through the Trotter path, TFIM-14 and TFIM-16 device stages on
    both routes, every check of the card's run but the launch counts."""
    smoke = _smoke()
    res = smoke.phase_spin_frontier(device="cpu", rehearsal=True)
    text = capsys.readouterr().out
    lines = {ln.split(": ", 1)[0]: json.loads(ln.split(": ", 1)[1])
             for ln in text.splitlines()
             if ln.startswith("spin frontier ")}
    assert list(lines) == ["spin frontier tfim12", "spin frontier tfim14",
                           "spin frontier tfim16"]
    assert lines == {f"spin frontier {k}": v for k, v in
                     json.loads(json.dumps(res["lines"])).items()}
    study = lines["spin frontier tfim12"]
    assert study["trotter"] and study["krylov_dim"] == 16
    assert (study["shots"], study["dt"]) == (300_000, 0.1)
    assert 0.0 <= study["error_mha"] < 10.0
    assert study["x_sweep_launches"] == study["plain_rotations_on_card"] == 0
    assert study["eigensolve_rows"] == [study["basis_size"]]
    for n, routes in ((14, ["ell-fused"]),
                      (16, ["ell-fused", "flip-stepped"])):
        line = lines[f"spin frontier tfim{n}"]
        assert list(line["routes"]) == routes and line["dim"] == 1 << n
        for route, run in line["routes"].items():
            assert run["route"] == route and run["ell_launches"] == 0
            assert abs(run["device_gap"]) < smoke.EIGENSOLVER_TOL
    assert res["by_path"] == {
        "eigensolver.exact_fullspace_ground_state(tfim, 14)": 0,
        "eigensolver.exact_fullspace_ground_state(tfim, 16)": 0}
    assert res["sweep_by_path"] == {
        "skqd_lattice_validation.run_large_convergence_study(tfim, 12)": 0}
    assert res["rows"] == res["sweep_rows"] == []
