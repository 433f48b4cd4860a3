"""Port parity of the public API: every name in each JAX module's
``__all__`` resolves in the port's counterpart module, except the names
listed in ``NOT_CARRIED`` with their reasons; and the small additions
that close the gap compute what the JAX functions compute."""

import importlib
import pkgutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flow_guided_krylov_tpu
from flow_guided_krylov_tpu.hamiltonians import molecular as jmol
from flow_guided_krylov_tpu.ops import bits as jbits
from flow_guided_krylov_tpu.utils import connection_table as jct
from flow_guided_krylov_torch.hamiltonians import molecular as pmol
from flow_guided_krylov_torch.ops import bits as pbits
from flow_guided_krylov_torch.utils import connection_table as pct

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_models import _flow_pair  # noqa: E402

torch.set_num_threads(1)

_MXU = ("a TPU MXU one-hot variant of the connection kernel or its "
        "router; the port has one connection function (ROADMAP.md, ground "
        "rules)")
_SHARDING = ("a jax.sharding name; a port mesh is a tuple of devices "
             "held in one process (parallel/mesh.py)")
# JAX module (relative to the package) -> {name: why the port lacks it}
NOT_CARRIED = {
    "ops": {"make_connection_fn_mxu": _MXU,
            "make_connection_fn_mxu_pair": _MXU,
            "connection_kernel_choice": _MXU},
    "ops.slater": {"make_connection_fn_mxu": _MXU,
                   "make_connection_fn_mxu_pair": _MXU,
                   "connection_kernel_choice": _MXU},
    "parallel": {n: _SHARDING for n in ("data_sharding", "replicated", "P",
                                        "NamedSharding")},
    "parallel.mesh": {n: _SHARDING for n in ("data_sharding", "replicated",
                                             "P", "NamedSharding")},
    "parallel.sharded_trotter": {
        "STATE": "a jax.sharding PartitionSpec of the statevector; the "
                 "port holds one block a mesh entry"},
    "ops.pallas_spmv": {
        "make_ell_spmv": "builds a Pallas callable; the port calls "
                         "ops.ell_spmv.ell_spmv, which launches "
                         "csrc/ell_spmv.cu on a CUDA tensor"},
    "ops.pallas_trotter": {
        "sweep_supported": "the TPU's Pallas gate (_pallas_supported); "
                           "the port's planner refuses a word no tile "
                           "holds on every device"},
}
# the two Pallas modules' counterparts hold the hand-written kernels
COUNTERPART = {"ops.pallas_spmv": "ops.ell_spmv",
               "ops.pallas_trotter": "ops.x_sweep"}


def _jax_modules():
    names = [""]
    for m in pkgutil.walk_packages(flow_guided_krylov_tpu.__path__,
                                   "flow_guided_krylov_tpu."):
        names.append(m.name[len("flow_guided_krylov_tpu."):])
    return sorted(names)


@pytest.mark.parametrize("rel", _jax_modules(), ids=lambda r: r or "top")
def test_every_exported_name_resolves_in_the_port(rel):
    jm = importlib.import_module(
        "flow_guided_krylov_tpu" + ("." + rel if rel else ""))
    exported = list(getattr(jm, "__all__", []))
    if rel == "":
        exported.append("run_molecular_benchmark")   # its lazy __getattr__
    target = COUNTERPART.get(rel, rel)
    pm = importlib.import_module(
        "flow_guided_krylov_torch" + ("." + target if target else ""))
    skip = NOT_CARRIED.get(rel, {})
    missing = [n for n in exported if n not in skip and not hasattr(pm, n)]
    assert not missing, f"{pm.__name__} lacks {missing}"
    # the list names only what the JAX module exports and the port lacks
    for name in skip:
        assert name in exported and not hasattr(pm, name), name
    if hasattr(jm, "__all__") and rel not in COUNTERPART:
        carried = [n for n in jm.__all__ if n not in skip]
        assert set(carried) <= set(getattr(pm, "__all__", carried))


def test_estimate_discrete_prob_matches_jax():
    jf, params, pf = _flow_pair()
    configs, _ = jf.apply(params, jax.random.PRNGKey(5), 64,
                          jnp.float32(1.0), method=jf.sample)
    want = np.asarray(jf.apply(params, configs,
                               method=jf.estimate_discrete_prob))
    got = pf.estimate_discrete_prob(torch.tensor(np.asarray(configs)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=0)
    assert (want > 0).all()


def test_from_keys_and_pack_device_match_jax():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 1 << 32, size=(200, 2), dtype=np.uint64
                          ).astype(np.uint32)
    keys = jbits.keys_np(packed)
    np.testing.assert_array_equal(pbits.from_keys_np(keys),
                                  jbits.from_keys_np(keys))
    np.testing.assert_array_equal(pbits.from_keys_np(keys), packed)
    occ = rng.integers(0, 2, size=(50, 32))
    want = np.asarray(jbits.pack_device(jnp.asarray(occ, jnp.int32)))
    got = pbits.pack_device(torch.tensor(occ))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        pbits.occupancy(got, 32).numpy(), occ)


@pytest.mark.parametrize("name", ["lih", "h2o"])
def test_section_sizes_match_jax(name):
    jh = jmol.MOLECULE_FACTORIES[name]()
    ph = pmol.MOLECULE_FACTORIES[name]("cpu")
    sizes = ph.tables.section_sizes()
    assert sizes == jh.tables.section_sizes()
    assert sum(sizes) == ph.n_connections


def test_connection_table_key_of_orders_as_jax():
    jh = jmol.create_lih_hamiltonian()
    ph = pmol.create_lih_hamiltonian("cpu")
    jt, pt = jct.build_connection_table(jh), pct.build_connection_table(ph)
    basis = jh.enumerate_basis()
    rng = np.random.default_rng(0)
    rows = basis[rng.permutation(len(basis))]
    want = np.asarray(jt.key_of(jnp.asarray(rows)))
    got = pt.key_of(pbits.to_device(rows, "cpu")).numpy()
    # one key a determinant, in the JAX key's order
    assert len(np.unique(got)) == len(rows)
    np.testing.assert_array_equal(np.argsort(got, kind="stable"),
                                  np.argsort(want, kind="stable"))
    np.testing.assert_array_equal(
        pt.lookup(pbits.to_device(rows, "cpu")).numpy(),
        np.asarray(jt.lookup(jnp.asarray(rows))))
