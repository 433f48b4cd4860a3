"""Port parity: determinant bits, Slater tables, connections and diagonal.

The same integrals go through the JAX package (on the CPU) and through
flow_guided_krylov_torch; targets must be bit-identical and elements
agree to float32 tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_guided_krylov_tpu.hamiltonians.molecular import \
    create_lih_hamiltonian as jax_lih
from flow_guided_krylov_tpu.ops import slater as jslater
from flow_guided_krylov_torch.convert import tables_from_jax
from flow_guided_krylov_torch.hamiltonians.molecular import (
    MolecularHamiltonian, synthetic_integrals)
from flow_guided_krylov_torch.ops import bits, slater

torch.set_num_threads(1)

SHAPES = [(4, 1, 1), (6, 2, 2), (6, 3, 2), (8, 3, 3)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def systems():
    out = [(f"synthetic{s}", synthetic_integrals(*s, seed=i))
           for i, s in enumerate(SHAPES)]
    return out + [("lih", jax_lih().integrals)]


@pytest.fixture(scope="module", params=systems(), ids=lambda s: s[0])
def pair(request):
    """(JAX tables, port Hamiltonian on the CPU, basis) for one system."""
    ints = request.param[1]
    jt = jslater.build_tables(ints.h1e, ints.h2e, ints.nuclear_repulsion,
                              ints.n_alpha, ints.n_beta)
    h = MolecularHamiltonian(ints, device="cpu")
    return jt, h, h.enumerate_basis()


def test_build_tables_equal(pair):
    jt, h, _ = pair
    pt = h.tables
    for name in ("n_orb", "n_alpha", "n_beta", "e_nuc", "n_connections"):
        assert getattr(pt, name) == getattr(jt, name)
    for name in ("h1", "h2", "jj", "ex", "jmat", "kmat", "ab_grid"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name))
    for spec in ("spec_a", "spec_b"):
        for g in ("singles", "doubles"):
            np.testing.assert_array_equal(getattr(getattr(pt, spec), g),
                                          getattr(getattr(jt, spec), g))
    # the converter carries the JAX tables over unchanged
    ct = tables_from_jax(jt)
    for name in ("h1", "h2", "jj", "ex", "jmat", "kmat", "ab_grid"):
        np.testing.assert_array_equal(getattr(ct, name), getattr(jt, name))
    assert ct.n_connections == jt.n_connections


def test_connections_match_jax_and_host(pair):
    jt, h, basis = pair
    j_conn, j_el = jslater.make_connection_fn(jt)(jnp.asarray(basis))
    n_conn, n_el = jslater.connections_batch_np(basis, jt)
    # a small chunk exercises the chunked path on the larger spaces
    fn = slater.make_connection_fn(h.tables, "cpu", chunk=64)
    p_conn, p_el = fn(bits.to_device(basis, "cpu"))
    assert p_conn.dtype == torch.int64 and p_el.dtype == torch.float32
    p_conn = bits.to_host(p_conn)
    np.testing.assert_array_equal(p_conn, np.asarray(j_conn))
    np.testing.assert_array_equal(p_conn, n_conn)
    np.testing.assert_allclose(p_el.numpy(), np.asarray(j_el), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(p_el.numpy(), n_el, rtol=0, atol=1e-5)
    # the port's host mirror is the JAX package's, bit for bit
    h_conn, h_el = h.connections_np(basis)
    np.testing.assert_array_equal(h_conn, n_conn)
    np.testing.assert_array_equal(h_el, n_el)


def test_diagonal_matches_jax_and_host(pair):
    jt, h, basis = pair
    j_d = np.asarray(jslater.diagonal_batch(jnp.asarray(basis), jt))
    n_d = jslater.diagonal_batch_np(basis, jt)
    p_d = h.diagonal_device(bits.to_device(basis, "cpu"))
    assert p_d.dtype == torch.float32
    np.testing.assert_allclose(p_d.numpy(), j_d, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_d.numpy(), n_d, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(h.diagonal_np(basis), n_d)


def test_bits_host_and_device_forms():
    from flow_guided_krylov_tpu.ops import bits as jbits
    rng = np.random.default_rng(5)
    n = 32
    occ = rng.integers(0, 2, size=(64, 2 * n))
    packed = bits.pack_np(occ, n)
    np.testing.assert_array_equal(packed, jbits.pack_np(occ, n))
    np.testing.assert_array_equal(bits.unpack_np(packed, n),
                                  jbits.unpack_np(packed, n))
    np.testing.assert_array_equal(bits.keys_np(packed),
                                  jbits.keys_np(packed))
    dev = bits.to_device(packed, "cpu")
    np.testing.assert_array_equal(bits.to_host(dev), packed)
    np.testing.assert_array_equal(
        bits.unpack_device(dev, n).numpy(),
        np.asarray(jbits.unpack_device(jnp.asarray(packed), n)))
    # device keys sort like the host's uint64 keys, bit 31 set or not
    order_dev = torch.argsort(bits.keys_device(dev)).numpy()
    np.testing.assert_array_equal(
        bits.keys_np(packed)[order_dev], np.sort(bits.keys_np(packed)))
    p = rng.integers(0, n, size=(64, 7))
    q = rng.integers(0, n, size=(64, 7))
    want = np.asarray(jbits.parity_between(
        jnp.asarray(packed[:, :1]), jnp.asarray(p), jnp.asarray(q)))
    got = bits.parity_between(dev[:, :1], torch.as_tensor(p),
                              torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bits.parity_between_np(packed[:, :1], p, q),
        jbits.parity_between_np(packed[:, :1], p, q))


def test_port_imports_no_jax():
    """Every port module imports without pulling in JAX, Flax or Optax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import flow_guided_krylov_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "FGK_PLATFORM"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_names_only_the_port():
    """chip_smoke.py drives the port alone: none of its imports names JAX
    or the JAX package."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert any(m.startswith("flow_guided_krylov_torch") for m in mods)
    bad = [m for m in mods if m.split(".")[0] in
           ("jax", "flax", "optax", "flow_guided_krylov_tpu")]
    assert not bad, bad


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "FGK_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _random_dets(n, ka, kb, count, seed):
    """``count`` random particle-conserving determinants, (count, 2) uint32."""
    rng = np.random.default_rng(seed)

    def words(k):
        occ = np.argsort(rng.random((count, n)), axis=1)[:, :k]
        return (np.uint64(1) << occ.astype(np.uint64)).sum(1).astype(np.uint32)

    return np.stack([words(ka), words(kb)], -1)


@pytest.mark.parametrize("n,ka,kb", [(10, 7, 7), (14, 5, 5), (32, 2, 2)],
                         ids=["10:7", "14:5", "32:2"])
def test_connections_at_wide_shapes(n, ka, kb):
    """The bench shapes (N2 10:7, N2/cc-pVDZ 14:5) and the single-word
    ceiling n_orb = 32, where orbital 31 sets the top bit of a uint32
    word, on random determinants."""
    ints = synthetic_integrals(n, ka, kb, seed=n)
    jt = jslater.build_tables(ints.h1e, ints.h2e, ints.nuclear_repulsion,
                              ka, kb)
    h = MolecularHamiltonian(ints, device="cpu")
    dets = _random_dets(n, ka, kb, 48, seed=n)
    if n == 32:
        dets[0] = [0x80000001, 0xC0000000]
    j_conn, j_el = jslater.make_connection_fn(jt)(jnp.asarray(dets))
    p_conn, p_el = h.connections_device(bits.to_device(dets, "cpu"))
    np.testing.assert_array_equal(bits.to_host(p_conn), np.asarray(j_conn))
    np.testing.assert_allclose(p_el.numpy(), np.asarray(j_el), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        h.diagonal_device(bits.to_device(dets, "cpu")).numpy(),
        jslater.diagonal_batch_np(dets, jt), rtol=0, atol=1e-4)
    # device keys order the connections like the host's uint64 keys
    flat = p_conn.reshape(-1, 2)
    order = torch.argsort(bits.keys_device(flat)).numpy()
    ranked = h.keys(bits.to_host(flat))[order]
    assert np.all(ranked[1:] >= ranked[:-1])
