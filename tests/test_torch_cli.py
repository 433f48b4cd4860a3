"""The port's entry points (``flow_guided_krylov_torch/examples/``) on the
CPU, against the JAX package's example CLIs.

* Every CLI: ``--help`` through ``python -m`` semantics (``runpy``, all
  eight in one fresh process) exits 0, and its flags are the JAX CLI's
  plus ``--device``;
  ``bench``'s JSON keys are ``bench.py``'s.
* Deterministic functions against the JAX CLI's output on the same
  system, to 1e-8 Ha with equal basis sizes and equal results keys:
  ``pt2_only_run``, ``run_sci``, ``extrapolate_de2``, ``exact_oracle``,
  ``run_large_spin_sci``, ``run_exact_fullspace``, the ``sci+skqd`` glue
  and the CCSD fallback, and ``bench``'s time to accuracy.
* The sampled runs, on the systems of ``tests/test_examples_exec.py``,
  held to the same physics asserts as the JAX tests there.
"""

import ast
import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from flow_guided_krylov_torch.chem import (compute_active_space_integrals,
                                           compute_molecular_integrals)
from flow_guided_krylov_torch.examples import bench as pbench
from flow_guided_krylov_torch.examples import benchmark as pbenchmark
from flow_guided_krylov_torch.examples import graft_entry
from flow_guided_krylov_torch.examples import large_system_benchmark as plarge
from flow_guided_krylov_torch.examples import \
    moderate_system_benchmark as pmod
from flow_guided_krylov_torch.examples import resolve_device
from flow_guided_krylov_torch.examples import skqd_lattice_validation as plat
from flow_guided_krylov_torch.examples import skqd_necessity_test as pnec
from flow_guided_krylov_torch.examples import skqd_validation as pval
from flow_guided_krylov_torch.hamiltonians import MolecularHamiltonian

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_TOL = 1e-8
# port module -> the JAX script it ports
CLIS = {
    "benchmark": "examples/benchmark.py",
    "bench": "bench.py",
    "large_system_benchmark": "examples/large_system_benchmark.py",
    "moderate_system_benchmark": "examples/moderate_system_benchmark.py",
    "skqd_lattice_validation": "examples/skqd_lattice_validation.py",
    "skqd_validation": "examples/skqd_validation.py",
    "skqd_necessity_test": "examples/skqd_necessity_test.py",
    "graft_entry": "__graft_entry__.py",
}


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))


def _jax_example(path):
    """Import one of the JAX package's scripts as a module."""
    name = "jax_" + os.path.basename(path)[:-3].strip("_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, path))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _jax_flags(path):
    """The first option string of each ``add_argument`` in a JAX script."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    flags = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            flags.add(node.args[0].value)
    return flags


_HELP_SCRIPT = """
import contextlib, io, json, runpy, sys
out = {}
for name in sys.argv[1:]:
    buf, code = io.StringIO(), None
    sys.argv = [name, "--help"]
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("flow_guided_krylov_torch.examples." + name,
                             run_name="__main__", alter_sys=True)
        except SystemExit as exc:
            code = exc.code
    out[name] = [code, buf.getvalue()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_help():
    """``python -m flow_guided_krylov_torch.examples.<name> --help`` for
    every CLI, through ``runpy`` as ``-m`` runs it, in one fresh process:
    {name: (exit code, help text)}."""
    out = subprocess.run([sys.executable, "-c", _HELP_SCRIPT, *sorted(CLIS)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_help_and_flags(name, port_help):
    code, text = port_help[name]
    assert code == 0, text
    usage = text.split("\n\n")[0]
    flags = {tok.strip("[]") for tok in usage.split()
             if tok.strip("[]").startswith("-")}
    assert flags == _jax_flags(CLIS[name]) | {"-h", "--device"}


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pbenchmark.pt2_only_run("h2")
    assert resolve_device("cpu") == torch.device("cpu")


def _bench_py_keys():
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("bench.py prints no dict")


def test_bench_line_keys_and_rate(monkeypatch):
    assert list(pbench.BENCH_KEYS) == _bench_py_keys()
    monkeypatch.setattr(pbench, "DEVICE_ITERS", 1)
    monkeypatch.setattr(pbench, "HOST_RUNS", 1)
    rates = pbench.connection_rate("cpu")
    assert rates["rate"] > 0 and rates["host_rate"] > 0
    assert rates["kernel"] == "ops/slater.py::make_connection_fn"
    monkeypatch.setattr(pbench, "connection_rate",
                        lambda device: dict(rates))
    monkeypatch.setattr(pbench, "time_to_accuracy",
                        lambda m, device: (0.5, 0.1, 300))
    buf = io.StringIO()
    with redirect_stdout(buf):
        pbench.main(["--device", "cpu"])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == _bench_py_keys()
    assert line["vs_baseline"] == round(rates["rate"] / rates["host_rate"], 2)
    assert line["host_rate_live"] == round(rates["host_rate"])


@pytest.mark.parametrize("molecule", ["h2", "lih"])
def test_bench_time_to_accuracy_matches_jax(molecule):
    jb = _jax_example("bench.py")
    got = pbench.time_to_accuracy(molecule, "cpu")
    want = jb.time_to_accuracy(molecule)
    assert got[1:] == want[1:]
    assert got[0] is not None and got[1] < 1.6


# ---------------------------------------------------------------------------
# Deterministic functions against the JAX CLIs
# ---------------------------------------------------------------------------

def _close(got, want, keys):
    assert set(got) == set(want)
    for k in keys:
        if isinstance(want[k], float):
            assert abs(got[k] - want[k]) < E_TOL, (k, got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("molecule", ["h2", "lih"])
def test_pt2_only_run_matches_jax(molecule):
    got = pbenchmark.pt2_only_run(molecule, device="cpu")
    want = _jax_example("examples/benchmark.py").pt2_only_run(molecule)
    _close(got, want, list(want))
    assert got["chemical_accuracy"]


def _h2o_tiny(device="cuda"):
    ang = np.radians(104.5)
    geom = [("O", (0, 0, 0)), ("H", (0.96, 0, 0)),
            ("H", (0.96 * np.cos(ang), 0.96 * np.sin(ang), 0))]
    act = compute_active_space_integrals(compute_molecular_integrals(geom),
                                         n_frozen=2, n_active=4)
    return MolecularHamiltonian(act, device)


def _jax_h2o_tiny():
    from flow_guided_krylov_tpu.chem import \
        compute_active_space_integrals as jact
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals as ji
    from flow_guided_krylov_tpu.hamiltonians import \
        MolecularHamiltonian as JMH
    ang = np.radians(104.5)
    geom = [("O", (0, 0, 0)), ("H", (0.96, 0, 0)),
            ("H", (0.96 * np.cos(ang), 0.96 * np.sin(ang), 0))]
    return JMH(jact(ji(geom), n_frozen=2, n_active=4))


@pytest.fixture
def tiny_systems(monkeypatch):
    jl = _jax_example("examples/large_system_benchmark.py")
    monkeypatch.setitem(plarge.SYSTEMS, "h2o_tiny_test", _h2o_tiny)
    monkeypatch.setitem(jl.SYSTEMS, "h2o_tiny_test", _jax_h2o_tiny)
    return jl


def test_run_sci_and_sci_skqd_glue_match_jax(tiny_systems):
    jl = tiny_systems
    h, jh = _h2o_tiny("cpu"), _jax_h2o_tiny()
    exact = h.fci_energy()
    assert abs(exact - jh.fci_energy()) < E_TOL
    got = plarge.run_sci(h, exact, iters=3, per_iter=4, max_basis=12)
    want = jl.run_sci(jh, exact, iters=3, per_iter=4, max_basis=12)
    np.testing.assert_array_equal(got.pop("_basis"), want.pop("_basis"))
    _close(got, want, list(want))

    kw = dict(mode="sci+skqd", sci_iters=3, sci_per_iter=4,
              sci_max_basis=12, krylov_dim=3, shots=4000)
    got = plarge.run("h2o_tiny_test", device="cpu", **kw)
    want = jl.run("h2o_tiny_test", **kw)
    assert set(got) == set(want)
    for k in ("final_energy", "basis_size", "pt2_de2",
              "pt2_corrected_energy", "pt2_exact", "exact_energy",
              "n_valid", "skqd_restricted_dim"):
        _close({k: got[k]}, {k: want[k]}, [k])
    # sampled stage 4: the JAX test's physics
    assert got["skqd_restricted_dim"] >= got["basis_size"]
    assert got["skqd_energy"] <= got["final_energy"] + 1e-9


def test_extrapolate_de2_matches_jax():
    jl = _jax_example("examples/large_system_benchmark.py")
    rng = np.random.default_rng(8)
    rows = [{"basis_size": int(b), "e_var": -100.0 + 0.01 * i,
             "de2": -0.02 / (i + 1) + 1e-4 * rng.normal(),
             "exact": bool(i != 2)}
            for i, b in enumerate((1000, 3000, 9000, 27000))]
    for kw in ({}, {"e_var_final": -99.9, "de2_final": -0.001,
                    "final_exact": True}):
        got, want = plarge.extrapolate_de2(rows, **kw), \
            jl.extrapolate_de2(rows, **kw)
        assert got == want
        assert "extrapolated_energy" in got
    assert "extrapolated_energy" not in plarge.extrapolate_de2(rows[:1])


@pytest.mark.parametrize("model,n,h", [
    ("tfim", 8, 0.5), ("heisenberg", 8, 0.1), ("heisenberg-hx", 8, 0.3),
    ("tfim", 16, 1.0), ("heisenberg", 15, 0.1)])
def test_exact_oracle_matches_jax(model, n, h):
    jlat = _jax_example("examples/skqd_lattice_validation.py")
    ham, init = plat.make_hamiltonian(model, n, h, device="cpu")
    jham, jinit = jlat.make_hamiltonian(model, n, h)
    np.testing.assert_array_equal(init, jinit)
    assert abs(plat.exact_oracle(ham) - jlat.exact_oracle(jham)) < E_TOL
    assert plat.tfim_free_fermion_energy(n, 1.0, h) == \
        jlat.tfim_free_fermion_energy(n, 1.0, h)


@pytest.mark.parametrize("args,kw", [
    (("heisenberg", 8, 0.1), dict(iters=12, per_iter=10)),
    (("heisenberg", 8, 0.1), dict(iters=12, per_iter=10, screen=1.0)),
    (("heisenberg-hx", 8, 0.3), dict(iters=12, per_iter=30)),
    (("tfim", 8, 1.0), dict(iters=10, per_iter=30)),
    (("heisenberg", 10, 0.1), dict(iters=40, per_iter=8, growth=0.5)),
])
def test_large_spin_sci_matches_jax(args, kw):
    jlat = _jax_example("examples/skqd_lattice_validation.py")
    got = plat.run_large_spin_sci(*args, device="cpu", **kw)
    want = jlat.run_large_spin_sci(*args, **kw)
    _close(got, want, [k for k in want if k not in ("wall_s",)])
    assert got["error_mha"] >= -1e-6


def test_large_spin_sci_dmrg_oracle_path(monkeypatch):
    monkeypatch.setattr(plat, "SECTOR_ORACLE_MAX_DIM", 0)
    out = plat.run_large_spin_sci("heisenberg", 8, 0.1, iters=12,
                                  per_iter=10, device="cpu")
    assert out["oracle"].startswith("dmrg")
    assert out["error_mha"] >= -1e-5
    assert abs(out["error_mha"]) < 1.0


@pytest.mark.parametrize("model,h,oracle", [("tfim", 1.0, "free-fermion"),
                                            ("heisenberg-hx", 0.3, "dense")])
def test_exact_fullspace_matches_jax(model, h, oracle):
    jlat = _jax_example("examples/skqd_lattice_validation.py")
    got = plat.run_exact_fullspace(model, 10, h, device="cpu")
    want = jlat.run_exact_fullspace(model, 10, h)
    assert got["dim"] == want["dim"] == 1024
    assert got["oracle"] == want["oracle"] == oracle
    for k in ("energy", "oracle_energy"):
        assert abs(got[k] - want[k]) < E_TOL, k
    assert abs(got["error_mha"]) < 1e-6


def test_moderate_ccsd_fallback_matches_jax(monkeypatch):
    """The FCI-infeasible branch (H2 with the FCI limit forced to 1): the
    JAX CLI's keys and its CCSD(T) oracle on the same integrals (the JAX
    pipeline itself is not rerun: on H2 both end at FCI)."""
    from flow_guided_krylov_tpu.chem.ccsd import ccsd_reference_dict
    from flow_guided_krylov_tpu.hamiltonians import MOLECULE_FACTORIES
    monkeypatch.setitem(pmod.GEOMETRIES, "h2_ccsd_test",
                        ([("H", (0, 0, 0)), ("H", (0, 0, 0.74))], "sto-3g"))
    monkeypatch.setattr(pmod, "FCI_LIMIT", 1)
    got = pmod.run("h2_ccsd_test", "fast", device="cpu")
    jh = MOLECULE_FACTORIES["h2"]()
    want = ccsd_reference_dict(jh.integrals, got["final_energy"])
    assert set(got) == {"molecule", "preset", "n_orbitals", "n_valid",
                        "final_energy", "hf_energy",
                        "correlation_recovered"} | set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=E_TOL), k
    assert abs(got["hf_energy"] - jh.integrals.hf_energy) < E_TOL
    assert abs(got["final_energy"] - jh.fci_energy()) < E_TOL
    assert got["ccsd_converged"]
    assert abs(got["error_vs_ccsd_mha"]) < 0.1
    assert got["ccsd_t_energy"] <= got["ccsd_energy"]


# ---------------------------------------------------------------------------
# Sampled runs: the physics asserts of tests/test_examples_exec.py
# ---------------------------------------------------------------------------

def test_benchmark_quick_nf_only_h2():
    out = pbenchmark.benchmark_molecule("h2", quick=True, nf_only=True,
                                        verbose=False, device="cpu")
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.1
    for key in ("nf_energy", "residual_energy", "final_energy"):
        assert key in out


def test_benchmark_main_table(monkeypatch):
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        pbenchmark.main(["--molecule", "h2", "--pt2-only", "--json",
                         "--device", "cpu"])
    assert exc.value.code == 0
    text = buf.getvalue()
    assert json.loads(text.splitlines()[2])["molecule"] == "h2"
    assert "1/1 within chemical accuracy (1.6 mHa)" in text


def test_skqd_validation_isolated_h2():
    out = pval.run_isolated("h2", device="cpu")
    assert out["experiment"] == "isolated"
    assert abs(out["nf_skqd_mha"]) < 0.1
    assert out["nf_basis_size"] >= 1


def test_skqd_necessity_h2_redundant():
    out = pnec.necessity_test("h2", residual_iters=2, krylov_dim=3,
                              verbose=False, device="cpu")
    assert out["verdict"] == "REDUNDANT"
    assert out["krylov_unique_configs"] == 0
    assert abs(out["nf_residual_mha"]) < 0.1


def test_lattice_three_mode_heisenberg6():
    out = plat.run_three_mode_experiment("heisenberg", 6, 0.1, krylov_dim=4,
                                         shots=2000, max_epochs=25,
                                         device="cpu")
    assert set(out["errors_mha"]) == {"skqd", "nf", "combined"}
    assert min(out["errors_mha"].values()) < 20.0
    assert out["best"] in ("skqd", "nf", "combined")


def test_moderate_benchmark_glue_tiny(monkeypatch):
    monkeypatch.setitem(pmod.GEOMETRIES, "h2_test",
                        ([("H", (0, 0, 0)), ("H", (0, 0, 0.74))], "sto-3g"))
    out = pmod.run("h2_test", "fast", device="cpu")
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.1
    assert out["n_valid"] == 4


def test_large_benchmark_pipeline_tiny_active_space(tiny_systems):
    out = plarge.run("h2o_tiny_test", "fast", device="cpu")
    assert out["n_valid"] == 16
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.1


def test_lattice_convergence_study_tiny():
    rows = plat.run_large_convergence_study(8, 1.0, points=[(3, 500, 0.1)],
                                            device="cpu")
    assert len(rows) == 1
    assert rows[0]["krylov_dim"] == 3
    assert np.isfinite(rows[0]["error_mha"])
    assert rows[0]["error_mha"] >= -1e-3


def test_lattice_sci_growth_schedule():
    fixed = plat.run_large_spin_sci("heisenberg", 10, 0.1, iters=40,
                                    per_iter=8, device="cpu")
    grown = plat.run_large_spin_sci("heisenberg", 10, 0.1, iters=40,
                                    per_iter=8, growth=0.5, device="cpu")
    assert grown["error_mha"] >= -1e-6
    assert abs(grown["error_mha"] - fixed["error_mha"]) < 0.5
    assert grown["iterations"] < fixed["iterations"]


def test_graft_entry_step():
    fn, args = graft_entry.entry(device="cpu")
    metrics = fn(*args)
    assert metrics.shape == (6,) and bool(torch.isfinite(metrics).all())
    assert fn.__self__.route == "fly"


# the keys of each line ``chip_smoke.phase_headline`` prints
HEADLINE_KEYS = {
    "n_valid", "tier", "nqs_hidden_dims", "samples_per_batch", "max_epochs",
    "epochs_run", "route", "stage_walls_s", "accumulated_energy_s",
    "median_epoch_ms", "nf_basis_size", "nf_error_mha",
    "residual_basis_size", "residual_error_mha", "stage3_iterations",
    "error_mha", "record_error_mha", "stage4", "wall_s",
    "peak_memory_bytes", "kernel_launches", "stage3_scoring_rounds"}


def test_chip_smoke_headline_rehearsal(capsys):
    """``chip_smoke.phase_headline``'s glue without a card: H2 and LiH
    through the benchmark CLI at ``--quick`` and H2S through the moderate
    CLI, each line carrying its keys, stage 4 by the reference's rule and
    the CLI's summary table."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.phase_headline(device="cpu", rehearsal=True)
    text = capsys.readouterr().out
    lines = {ln.split(":")[0]: json.loads(ln.split(": ", 1)[1])
             for ln in text.splitlines()
             if ln.startswith(("headline ", "moderate "))}
    assert sorted(lines) == ["headline h2", "headline lih", "moderate h2s"]
    for name, line in lines.items():
        assert HEADLINE_KEYS <= set(line), name
        assert line == json.loads(json.dumps(res[name.split()[1]]))
        assert -1e-6 <= line["error_mha"] < 1.6
        assert line["stage4"] == "residual already < 1 mHa"
        assert line["kernel_launches"] == {"ell_spmv": 0, "x_sweep": 0}
        assert line["peak_memory_bytes"] is None
    assert {lines[f"headline {m}"]["record_nf_basis"]
            for m in ("h2", "lih")} == {4, 225}
    assert lines["headline h2"]["record_stage4"] == "residual already < 1 mHa"
    assert lines["moderate h2s"]["n_valid"] == 2025
    assert lines["moderate h2s"]["tier"] == "medium"
    assert "2/2 within chemical accuracy (1.6 mHa)" in text
