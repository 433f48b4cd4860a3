"""The port's own ``chem`` against the JAX package's: the same molecular
integrals, bit for bit, computed afresh by each package in a temporary
cache directory, and the cache files readable by both.

Bit equality needs both packages on the same ERI engine (the native C++
one, or the NumPy one): the test asserts that first, so that a failed
build on one side cannot pass unseen.  The JAX loader compiles in place
and remembers a failed load for the process's life, so a test worker
that loaded its library while another worker was writing it would run
the NumPy engine to the end; the module fixture :func:`_jax_engine`
rebuilds that library race-free for such a worker before the comparison
(the port's loader builds under a temporary name)."""

import contextlib
import fcntl
import importlib.util
import os
import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from flow_guided_krylov_tpu.chem import compute_molecular_integrals as jax_mi
from flow_guided_krylov_tpu.chem import native as jax_native
from flow_guided_krylov_tpu.hamiltonians import molecular as jax_mol
from flow_guided_krylov_torch.chem import compute_molecular_integrals
from flow_guided_krylov_torch.chem import native
from flow_guided_krylov_torch.examples import \
    moderate_system_benchmark as moderate
from flow_guided_krylov_torch.hamiltonians import molecular as mol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ANG = np.radians(104.5)
GEOMETRIES = {
    "h2": [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 0.74))],
    "lih": [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.6))],
    "h2o": [("O", (0.0, 0.0, 0.0)), ("H", (0.96, 0.0, 0.0)),
            ("H", (0.96 * np.cos(_ANG), 0.96 * np.sin(_ANG), 0.0))],
}
# the systems of the published tables whose geometries live in the two
# packages' molecule factories and moderate-system CLIs (H2S: the
# third-row STO-3G refit of ``chem/basis.py``)
FACTORY_MOLECULES = ("beh2", "nh3", "ch4")
MODERATE_MOLECULES = ("h2s", "hcn")
FIELDS = ("h1e", "h2e", "nuclear_repulsion", "n_alpha", "n_beta")
ACTIVE_FIELDS = FIELDS + ("n_electrons", "n_orbitals", "hf_energy",
                          "mo_energies")
# the SKQD validation suite's systems and the two frontier models, as the
# two packages' CLIs hand them to the chem front end
# (``examples/skqd_validation.py``, ``examples/large_system_benchmark.py``):
# name -> (CLI function, its arguments); the port's takes ``device`` too
VALIDATION_SYSTEMS = {
    "lih_631g": ("skqd_validation", "run_631g", ("lih",)),
    "h2o_631g": ("skqd_validation", "run_631g", ("h2o",)),
    "n2_stretched_1.3": ("skqd_validation", "build", ("n2", 1.3)),
    "h2o_stretched_1.5": ("skqd_validation", "build", ("h2o", 1.5)),
    "benzene_pi": ("large_system_benchmark", "benzene_pi", ()),
    "fe_porphyrin_model": ("large_system_benchmark", "fe_porphyrin_model",
                           ()),
}
# the front end's defaults, which the port's CLIs pass and the JAX
# package's leave out
SPEC_DEFAULTS = {"basis": "sto-3g", "charge": 0, "spin": 0}


class _Geometry(Exception):
    pass


def _factory_geometry(module, *args, name):
    """The geometry a molecule factory of ``module`` hands to
    ``compute_molecular_integrals``, caught before any integral."""
    def grab(geometry, *_, **__):
        raise _Geometry(geometry)
    with mock.patch.object(module, "compute_molecular_integrals", grab):
        with pytest.raises(_Geometry) as caught:
            module.MOLECULE_FACTORIES[name](*args)
    return caught.value.args[0]


def _jax_script(name):
    """The JAX package's ``examples/<name>.py``, loaded without running
    its command line."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def _jax_moderate_geometries():
    """``GEOMETRIES`` of the JAX package's ``examples/
    moderate_system_benchmark.py``, read without running the script."""
    return _jax_script("moderate_system_benchmark").GEOMETRIES


def _cli_spec(call, *targets):
    """(geometry, front-end keywords, (n_frozen, n_active) or None) that
    ``call`` hands to the chem front end, caught before any integral:
    ``targets`` are the (module, attribute) pairs through which the CLI
    reaches ``compute_molecular_integrals``,
    ``compute_active_space_integrals`` and ``MolecularHamiltonian``."""
    seen = {}

    def integrals(geometry, **kw):
        seen["spec"] = (geometry, {**SPEC_DEFAULTS, **kw})
        return "integrals"

    def active(_, n_frozen, n_active=None):
        raise _Geometry((*seen["spec"], (n_frozen, n_active)))

    def hamiltonian(*_, **__):
        raise _Geometry((*seen["spec"], None))

    fakes = {"compute_molecular_integrals": integrals,
             "compute_active_space_integrals": active,
             "MolecularHamiltonian": hamiltonian}
    with contextlib.ExitStack() as stack:
        for module, attr in targets:
            stack.enter_context(mock.patch.object(module, attr, fakes[attr]))
        with pytest.raises(_Geometry) as caught:
            call()
    return caught.value.args[0]


def _validation_spec(name):
    """A validation or frontier system's (geometry, keywords, window),
    taken from both packages' CLIs and held equal."""
    import flow_guided_krylov_tpu.chem as jchem
    import flow_guided_krylov_tpu.chem.active_space as jactive
    import flow_guided_krylov_tpu.hamiltonians as jham
    from flow_guided_krylov_torch.examples import large_system_benchmark
    from flow_guided_krylov_torch.examples import skqd_validation
    script, fn, args = VALIDATION_SYSTEMS[name]
    port = {"skqd_validation": skqd_validation,
            "large_system_benchmark": large_system_benchmark}[script]
    mine = _cli_spec(
        lambda: getattr(port, fn)(*args, device="cpu"),
        *((port, a) for a in ("compute_molecular_integrals",
                              "compute_active_space_integrals",
                              "MolecularHamiltonian")))
    ref = _cli_spec(
        lambda: getattr(_jax_script(script), fn)(*args),
        (jchem, "compute_molecular_integrals"),
        (jchem, "compute_active_space_integrals"),
        (jactive, "compute_active_space_integrals"),
        (jham, "MolecularHamiltonian"))
    assert mine == ref
    return mine


def _geometry(name):
    """A system's geometry, the same in both packages."""
    if name in GEOMETRIES:
        return GEOMETRIES[name]
    if name in MODERATE_MOLECULES:
        (mine, basis), (ref, ref_basis) = (moderate.GEOMETRIES[name],
                                           _jax_moderate_geometries()[name])
        assert basis == ref_basis == "sto-3g"
    else:
        mine = _factory_geometry(mol, "cpu", name=name)
        ref = _factory_geometry(jax_mol, name=name)
    assert mine == ref
    return mine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The BLAS and OpenMP pools at one thread, as torch's: the suite runs
    this file beside others on every core, where idle pool threads that
    spin take the cores other workers need."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module", autouse=True)
def _jax_engine():
    """If the JAX loader holds no library while g++ can build one, build
    ``native/integrals.cpp`` as that loader does, under a file lock, to a
    temporary name renamed into the loader's cache path, and let the
    loader load the finished file afresh."""
    gxx = shutil.which("g++")
    if jax_native.native_available() or gxx is None \
            or not os.path.exists(jax_native._SRC):
        return
    out = jax_native._LIB_CANDIDATES[-1]
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run([gxx, "-std=c++17", "-O3", "-march=native",
                        "-fopenmp", "-shared", "-fPIC", jax_native._SRC,
                        "-o", tmp], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, out)
        jax_native._tried, jax_native._lib = False, None
        jax_native._load()


def test_both_packages_use_the_same_eri_engine():
    assert native.native_available() == jax_native.native_available()


@pytest.mark.parametrize("name", sorted(GEOMETRIES) + list(FACTORY_MOLECULES)
                         + list(MODERATE_MOLECULES)
                         + list(VALIDATION_SYSTEMS))
def test_integrals_bit_equal_to_jax_package(name, tmp_path):
    """Each system's integrals, and, where its CLI folds a frozen-core
    window (H2O/6-31G (1, 10), benzene pi (18, 6), the Fe(II)N4 model
    (22, 10) at charge 2 and spin 4), that window's, bit for bit."""
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals as jax_active
    from flow_guided_krylov_torch.chem import compute_active_space_integrals
    if name in VALIDATION_SYSTEMS:
        geom, kw, window = _validation_spec(name)
    else:
        geom, kw, window = _geometry(name), {}, None
    assert native.native_available() == jax_native.native_available()
    mine = compute_molecular_integrals(geom, cache_dir=str(tmp_path / "port"),
                                       **kw)
    ref = jax_mi(geom, cache_dir=str(tmp_path / "jax"), **kw)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(ref, field), err_msg=field)
    # each reads the other's cache file: one format, one key
    again = compute_molecular_integrals(geom, cache_dir=str(tmp_path / "jax"),
                                        **kw)
    back = jax_mi(geom, cache_dir=str(tmp_path / "port"), **kw)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(again, field),
                                      getattr(ref, field), err_msg=field)
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(mine, field), err_msg=field)
    if window is not None:
        mine_w = compute_active_space_integrals(mine, *window)
        ref_w = jax_active(ref, *window)
        for field in ACTIVE_FIELDS:
            np.testing.assert_array_equal(getattr(mine_w, field),
                                          getattr(ref_w, field),
                                          err_msg=field)
        assert mine_w.n_orbitals == window[1]


def test_active_space_bit_equal_to_jax_package(tmp_path, monkeypatch):
    """Frozen-core folding on N2/STO-3G (two frozen 1s cores, as the
    cc-pVDZ (10e, 14o) space freezes them; cc-pVDZ integrals themselves
    take too long for this suite): every field bit for bit, with and
    without a window narrower than the remaining orbitals.  Then H2S as
    the moderate-system CLIs build it: the sulfur 1s core frozen, (16e,
    10o), and the port CLI's ``build`` on those integrals."""
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals as jax_active
    from flow_guided_krylov_torch.chem import compute_active_space_integrals
    geom = [("N", (0.0, 0.0, 0.0)), ("N", (0.0, 0.0, 1.10))]
    ints = compute_molecular_integrals(geom, cache_dir=str(tmp_path))
    for n_active in (None, 6):
        mine = compute_active_space_integrals(ints, 2, n_active)
        ref = jax_active(jax_mi(geom, cache_dir=str(tmp_path)), 2, n_active)
        for field in ACTIVE_FIELDS:
            np.testing.assert_array_equal(getattr(mine, field),
                                          getattr(ref, field), err_msg=field)
        assert mine.n_orbitals == (n_active or 8) and mine.n_alpha == 5
    with pytest.raises(ValueError):
        compute_active_space_integrals(ints, 2, 9)

    geom = _geometry("h2s")
    ints = compute_molecular_integrals(geom, cache_dir=str(tmp_path / "h2s"))
    mine = compute_active_space_integrals(ints, 1)
    ref = jax_active(jax_mi(geom, cache_dir=str(tmp_path / "h2s_jax")), 1)
    for field in FIELDS + ("n_electrons", "n_orbitals", "hf_energy",
                           "mo_energies"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(ref, field), err_msg=field)
    assert (mine.n_orbitals, mine.n_alpha, mine.n_beta) == (10, 8, 8)
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path / "h2s"))
    built = moderate.build("h2s", "cpu")
    assert built.n_valid_configs == 2025
    for field in FIELDS + ("hf_energy",):
        np.testing.assert_array_equal(getattr(built.integrals, field),
                                      getattr(ref, field), err_msg=field)


def test_cache_override_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    compute_molecular_integrals(GEOMETRIES["h2"])
    assert [p.suffix for p in tmp_path.iterdir()] == [".npz"]
