"""The port's own ``chem`` against the JAX package's: the same molecular
integrals, bit for bit, computed afresh by each package in a temporary
cache directory, and the cache files readable by both.

Bit equality needs both packages on the same ERI engine (the native C++
one, or the NumPy one): the test asserts that first, so that a failed
build on one side cannot pass unseen."""

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


def test_cache_override_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    compute_molecular_integrals(GEOMETRIES["h2"])
    assert [p.suffix for p in tmp_path.iterdir()] == [".npz"]
