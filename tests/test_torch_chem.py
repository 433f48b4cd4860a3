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

import fcntl
import importlib.util
import os
import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest

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


def _jax_moderate_geometries():
    """``GEOMETRIES`` of the JAX package's ``examples/
    moderate_system_benchmark.py``, read without running the script."""
    spec = importlib.util.spec_from_file_location(
        "jax_moderate_geometries",
        os.path.join(ROOT, "examples", "moderate_system_benchmark.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.GEOMETRIES


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
                         + list(MODERATE_MOLECULES))
def test_integrals_bit_equal_to_jax_package(name, tmp_path):
    geom = _geometry(name)
    assert native.native_available() == jax_native.native_available()
    mine = compute_molecular_integrals(geom, cache_dir=str(tmp_path / "port"))
    ref = jax_mi(geom, cache_dir=str(tmp_path / "jax"))
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(ref, field), err_msg=field)
    # each reads the other's cache file: one format, one key
    again = compute_molecular_integrals(geom, cache_dir=str(tmp_path / "jax"))
    back = jax_mi(geom, cache_dir=str(tmp_path / "port"))
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(again, field),
                                      getattr(ref, field), err_msg=field)
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(mine, field), err_msg=field)


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
        for field in FIELDS + ("n_electrons", "n_orbitals", "hf_energy",
                               "mo_energies"):
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
