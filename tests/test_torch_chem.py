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
import os
import shutil
import subprocess

import numpy as np
import pytest

from flow_guided_krylov_tpu.chem import compute_molecular_integrals as jax_mi
from flow_guided_krylov_tpu.chem import native as jax_native
from flow_guided_krylov_torch.chem import compute_molecular_integrals
from flow_guided_krylov_torch.chem import native

_ANG = np.radians(104.5)
GEOMETRIES = {
    "h2": [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 0.74))],
    "lih": [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.6))],
    "h2o": [("O", (0.0, 0.0, 0.0)), ("H", (0.96, 0.0, 0.0)),
            ("H", (0.96 * np.cos(_ANG), 0.96 * np.sin(_ANG), 0.0))],
}
FIELDS = ("h1e", "h2e", "nuclear_repulsion", "n_alpha", "n_beta")


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


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_integrals_bit_equal_to_jax_package(name, tmp_path):
    geom = GEOMETRIES[name]
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


def test_active_space_bit_equal_to_jax_package(tmp_path):
    """Frozen-core folding on N2/STO-3G (two frozen 1s cores, as the
    cc-pVDZ (10e, 14o) space freezes them; cc-pVDZ integrals themselves
    take too long for this suite): every field bit for bit, with and
    without a window narrower than the remaining orbitals."""
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


def test_cache_override_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    compute_molecular_integrals(GEOMETRIES["h2"])
    assert [p.suffix for p in tmp_path.iterdir()] == [".npz"]
