"""Port parity: the DMRG oracle (``postprocessing/dmrg.py``, a NumPy/SciPy
copy) against the JAX package's function and against exact
diagonalization on the CPU.

The chains are those of the JAX package's ``tests/test_dmrg.py`` and a
14-site chain.  The copy must give the JAX function's energy to 1e-10 Ha
on the same inputs, and ED's to 1e-9 Ha (dense up to 12 sites, scipy
``eigsh`` on the sparse H at 14).  Both caches are pointed at
``tmp_path``; the port's writes ``torch_dmrg_<sha>.json`` and never
reads the JAX package's ``dmrg_<sha>.json``.
"""

import json

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.postprocessing import dmrg as jdmrg
from flow_guided_krylov_torch.hamiltonians import spin as pspin
from flow_guided_krylov_torch.postprocessing import dmrg as pdmrg
from flow_guided_krylov_torch.postprocessing import dmrg_ground_state

torch.set_num_threads(1)

JAX_TOL = 1e-10
ED_TOL = 1e-9


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    return tmp_path


def _ed(h) -> float:
    n = h.n_sites
    if n <= 12:
        return float(np.linalg.eigvalsh(h.exact_dense()).min())
    states = np.arange(1 << n, dtype=np.uint32)[:, None]
    return float(spla.eigsh(h.to_sparse(states), k=1, which="SA",
                            tol=1e-12)[0][0])


def _models(kind, n):
    """(port H, JAX H) of one chain."""
    if kind == "heisenberg":
        hz = np.zeros(n)
        hz[0] = 0.1                     # the lattice-validation perturbation
        args, kw = (n, 1.0, 1.0, 1.0), dict(h_z=hz)
    elif kind == "xxz-fields":
        args, kw = (n, 0.8, 0.8, 0.55), dict(h_z=np.full(n, 0.07),
                                              h_x=np.full(n, 0.02))
    else:
        return (pspin.TransverseFieldIsing(n, V=1.0, h=0.8, periodic=False,
                                           device="cpu"),
                jspin.TransverseFieldIsing(n, V=1.0, h=0.8, periodic=False))
    return (pspin.HeisenbergHamiltonian(*args, **kw, device="cpu"),
            jspin.HeisenbergHamiltonian(*args, **kw))


@pytest.mark.parametrize("kind,n", [("heisenberg", 8), ("heisenberg", 12),
                                    ("heisenberg", 14), ("xxz-fields", 10),
                                    ("tfim-open", 10)])
def test_dmrg_matches_jax_and_ed(kind, n):
    h, jh = _models(kind, n)
    e, info = dmrg_ground_state(h, max_bond=64, sweeps=8)
    je, jinfo = jdmrg.dmrg_ground_state(jh, max_bond=64, sweeps=8)
    assert abs(e - je) < JAX_TOL
    assert info["sweeps"] == jinfo["sweeps"]
    assert abs(info["total_sz"] - jinfo["total_sz"]) < 1e-8
    assert e == pytest.approx(_ed(h), abs=ED_TOL)
    if kind == "heisenberg":
        assert info["truncation_error"] < 1e-10
        assert abs(info["total_sz"]) < 1e-6   # even-N AFM ground: S_z = 0


def test_dmrg_odd_chain_sector_matches_packed_convention():
    """An odd chain grounds in S_z = +/-1/2; the sign DMRG reports picks
    the popcount sector (bit 1 <-> sigma_z = +1) whose dense minimum it
    equals, and that sector holds the global ground state."""
    n = 11
    hz = np.zeros(n)
    hz[0] = 0.1
    h = pspin.HeisenbergHamiltonian(n, 1.0, 1.0, 1.0, h_z=hz, device="cpu")
    e, info = dmrg_ground_state(h, max_bond=64, sweeps=8)
    dense = h.exact_dense()
    pop = np.array([bin(s).count("1") for s in range(1 << n)])
    sector_min = {}
    for k in (n // 2, n // 2 + 1):
        idx = np.where(pop == k)[0]
        sector_min[k - n / 2.0] = float(
            np.linalg.eigvalsh(dense[np.ix_(idx, idx)]).min())
    sz = 0.5 if info["total_sz"] > 0 else -0.5
    assert abs(abs(info["total_sz"]) - 0.5) < 1e-6
    assert e == pytest.approx(sector_min[sz], abs=ED_TOL)
    assert sector_min[sz] == min(sector_min.values())


def test_dmrg_energy_is_variational():
    h = pspin.HeisenbergHamiltonian(12, 1.0, 1.0, 1.0, device="cpu")
    e, _ = dmrg_ground_state(h, max_bond=8, sweeps=4)
    assert e >= _ed(h) - 1e-12


def test_dmrg_rejects_periodic_and_short_chains():
    with pytest.raises(NotImplementedError):
        dmrg_ground_state(pspin.TransverseFieldIsing(10, V=1.0, h=1.0,
                                                     periodic=True,
                                                     device="cpu"))
    with pytest.raises(NotImplementedError):
        dmrg_ground_state(pspin.HeisenbergHamiltonian(10, periodic=True,
                                                      device="cpu"))
    with pytest.raises(ValueError):
        dmrg_ground_state(pspin.HeisenbergHamiltonian(2, device="cpu"))


def test_dmrg_cache_is_the_ports_own(_cache):
    h, jh = _models("heisenberg", 8)
    args = dict(max_bond=16, sweeps=4)
    je, _ = jdmrg.dmrg_ground_state(jh, **args)
    jfiles = sorted(p.name for p in _cache.iterdir())
    assert len(jfiles) == 1 and jfiles[0].startswith("dmrg_")
    # a JAX file under the port's key would be read; poison the JAX one:
    # the port must compute and write its own
    (_cache / jfiles[0]).write_text(json.dumps(
        {"energy": 1.0, "info": {}}))
    e, _ = dmrg_ground_state(h, **args)
    assert abs(e - je) < JAX_TOL
    names = sorted(p.name for p in _cache.iterdir())
    ported = [p for p in names if p.startswith("torch_dmrg_")]
    assert len(ported) == 1
    assert ported[0] == "torch_" + jfiles[0]
    # the second call reads the port's file
    payload = json.loads((_cache / ported[0]).read_text())
    assert payload["energy"] == e
    assert dmrg_ground_state(h, **args)[0] == e
    assert pdmrg._cache_path(pdmrg._build_mpo(h), 16, 4, 1e-9, 0).name \
        == ported[0]
