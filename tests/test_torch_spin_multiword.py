"""Port parity: spin chains of 32..64 sites (two words a configuration,
columns [hi, lo], sites 0..31 in the low word) against the JAX package on
the CPU.

The shapes and seeds are those of the JAX package's
``tests/test_spin_multiword.py``.  Held to: host diagonals and elements
to 1e-12 of a pure-Python reference, targets and keys bit-identical to
the JAX package's, device elements to float32 tolerance, Selected-CI
bases equal round for round with host and with forced device scoring (at
W = 2 the port keys a configuration with one int64, top bit flipped, and
takes the one-key scorer), and the exact dE2 on the device to 1e-8 Ha of
the host f64 path.
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov import residual_expansion as jre
from flow_guided_krylov_torch.hamiltonians import spin as pspin
from flow_guided_krylov_torch.krylov import residual_expansion as pre
from flow_guided_krylov_torch.ops.bits import to_device, to_host

torch.set_num_threads(1)

DEVICE_ELEM_TOL = 1e-6
DE2_TOL = 1e-8


def _heis(pkg, n, **kw):
    extra = {} if pkg is jspin else {"device": "cpu"}
    return pkg.HeisenbergHamiltonian(n, 1.0, 1.0, 1.0, **kw, **extra)


def _hz(n):
    hz = np.zeros(n)
    hz[0] = 0.1
    return hz


def slow_heisenberg(ham, x: int):
    """Pure-Python diagonal and {target: element} of one configuration."""
    n = ham.n_sites
    s = [2 * ((x >> i) & 1) - 1 for i in range(n)]
    diag = sum(ham.Jz / 4.0 * s[i] * s[j] for i, j in ham.bonds)
    diag += sum(s[i] * ham.h_z[i] / 2.0 for i in range(n))
    conns = {}
    for i, j in ham.bonds:
        y = x ^ (1 << i) ^ (1 << j)
        el = (ham.Jx + ham.Jy) / 4.0 if s[i] != s[j] else 0.0
        conns[y] = conns.get(y, 0.0) + el
    for i in range(n):
        if abs(ham.h_x[i]) > 1e-12:
            y = x ^ (1 << i)
            conns[y] = conns.get(y, 0.0) + ham.h_x[i] / 2.0
    return diag, conns


def random_packed(rng, n, count):
    xs = [int(rng.integers(0, 1 << n)) for _ in range(count)]
    return xs, np.stack([pspin.pack_spin_state(x, n) for x in xs])


@pytest.mark.parametrize("n", [33, 34, 40])
def test_heisenberg_w2_kernels_match_slow_reference_and_jax(n):
    rng = np.random.default_rng(7 + n)
    ham = _heis(pspin, n, h_z=_hz(n))
    jham = _heis(jspin, n, h_z=_hz(n))
    assert ham.pack_words == 2
    xs, packed = random_packed(rng, n, 12)
    assert np.array_equal(packed, np.stack([jspin.pack_spin_state(x, n)
                                            for x in xs]))
    assert all(pspin.spin_state_int(packed[k]) == xs[k]
               for k in range(len(xs)))
    d = ham.diagonal_np(packed)
    conn, el = ham.connections_np(packed)
    jconn, jel = jham.connections_np(packed)
    assert conn.shape == (len(xs), ham.n_connections, 2)
    assert np.array_equal(conn, jconn) and np.array_equal(el, jel)
    assert np.array_equal(d, jham.diagonal_np(packed))
    for k, x in enumerate(xs):
        dref, cref = slow_heisenberg(ham, x)
        assert d[k] == pytest.approx(dref, abs=1e-12)
        got = {}
        for c in range(conn.shape[1]):
            t = pspin.spin_state_int(conn[k, c])
            got[t] = got.get(t, 0.0) + el[k, c]
        for t, v in cref.items():
            assert got.get(t, 0.0) == pytest.approx(v, abs=1e-12)


@pytest.mark.parametrize("model", ["heisenberg-hx", "tfim"])
def test_w2_device_closures_match_host_and_jax(model):
    import jax.numpy as jnp
    n = 35
    rng = np.random.default_rng(3)
    if model == "tfim":
        ham = pspin.TransverseFieldIsing(n, V=1.0, h=0.5, device="cpu")
        jham = jspin.TransverseFieldIsing(n, V=1.0, h=0.5)
    else:
        ham = _heis(pspin, n, h_x=np.full(n, 0.2))
        jham = _heis(jspin, n, h_x=np.full(n, 0.2))
    xs, packed = random_packed(rng, n, 16)
    packed[0] = pspin.pack_spin_state((1 << n) - 1, n)     # bits 31, 32
    d = ham.diagonal_np(packed)
    conn, el = ham.connections_np(packed)
    rows = to_device(packed, "cpu")
    cd, ed = ham.connections_device(rows)
    cj, ej = jham.connections_device(jnp.asarray(packed))
    assert np.array_equal(to_host(cd), conn)
    assert np.array_equal(to_host(cd), np.asarray(cj))
    assert np.max(np.abs(ed.numpy() - el)) < DEVICE_ELEM_TOL
    assert np.max(np.abs(ham.diagonal_device(rows).numpy() - d)) < 1e-5


def test_w2_keys_match_jax_monotone_and_roundtrip():
    n = 37
    rng = np.random.default_rng(11)
    ham = pspin.TransverseFieldIsing(n, V=1.0, h=0.5, device="cpu")
    jham = jspin.TransverseFieldIsing(n, V=1.0, h=0.5)
    assert ham.pack_words == 2
    xs, packed = random_packed(rng, n, 64)
    keys = ham.keys(packed)
    assert np.array_equal(keys, jham.keys(packed))
    assert list(np.argsort(keys, kind="stable")) == \
        list(np.argsort(np.array(xs, dtype=object), kind="stable"))
    assert np.array_equal(ham.unkey(keys), packed)
    # the device key: one int64 with the top bit flipped, in the same order
    kd = ham.keys_device(to_device(packed, "cpu"))
    assert kd.shape == (64,)
    assert np.array_equal(ham.keys_to_host(kd), keys)
    assert np.array_equal(torch.argsort(kd, stable=True).numpy(),
                          np.argsort(keys, kind="stable"))


def test_w2_projected_hamiltonian_hermitian_and_physical():
    n = 33
    ham = _heis(pspin, n, h_z=_hz(n))
    seed = pspin.pack_spin_state(sum(1 << i for i in range(0, n, 2)),
                                 n)[None, :]
    conn, el = ham.connections_np(seed)
    basis = np.concatenate([seed, conn[0][np.abs(el[0]) > 1e-14]], axis=0)
    _, first = np.unique(ham.keys(basis), return_index=True)
    basis = basis[np.sort(first)]
    H = ham.matrix_elements(basis, basis)
    assert np.max(np.abs(H - H.T)) < 1e-12
    assert np.allclose(np.diag(H), ham.diagonal_np(basis))
    assert np.linalg.eigvalsh(H)[0] < ham.diagonal_np(seed)[0] - 1e-6


@pytest.mark.parametrize("force_device", [False, True],
                         ids=["host-scoring", "device-scoring"])
def test_w2_sci_trajectory_matches_jax(force_device):
    """Three rounds on the 33-site S_z-conserving chain from the Neel
    state, one expander a package: equal bases round for round."""
    n = 33
    ham = _heis(pspin, n, h_z=_hz(n))
    jham = _heis(jspin, n, h_z=_hz(n))
    seed_int = sum(1 << i for i in range(0, n, 2))
    kw = dict(max_iterations=4, configs_per_iteration=40,
              max_basis_size=200)
    pexp = pre.SelectedCIExpander(ham, pre.ResidualExpansionConfig(**kw),
                                  use_device_scoring=force_device)
    jexp = jre.SelectedCIExpander(jham, jre.ResidualExpansionConfig(**kw),
                                  use_device_scoring=force_device)
    pb = jb = pspin.pack_spin_state(seed_int, n)[None, :]
    e_prev = float(ham.diagonal_np(pb)[0])
    for _ in range(3):
        po, jo = pexp.expand_basis(pb), jexp.expand_basis(jb)
        pb, jb = po["basis"], jo["basis"]
        assert np.array_equal(pb, jb)
        assert po["energy"] == pytest.approx(jo["energy"], abs=1e-10)
        assert po["energy"] <= e_prev + 1e-9
        e_prev = po["energy"]
    pops = {bin(pspin.spin_state_int(row)).count("1") for row in pb}
    assert pops == {bin(seed_int).count("1")}


def test_w2_exact_de2_on_device_matches_host_and_jax():
    n = 33
    ham = _heis(pspin, n, h_z=_hz(n))
    jham = _heis(jspin, n, h_z=_hz(n))
    seed = pspin.pack_spin_state(sum(1 << i for i in range(0, n, 2)),
                                 n)[None, :]
    kw = dict(max_iterations=3, configs_per_iteration=60,
              max_basis_size=300)
    exp = pre.SelectedCIExpander(ham, pre.ResidualExpansionConfig(**kw))
    basis = seed
    for _ in range(3):
        basis = exp.expand_basis(basis)["basis"]
    e, vec = exp._diagonalize(basis)
    dev = exp.pt2_correction(basis, vec, e)           # the device block
    host = exp._pt2_correction_host(basis, vec, e)
    jexp = jre.SelectedCIExpander(jham, jre.ResidualExpansionConfig(**kw))
    jexp._pt2_row_cap = 0                             # the JAX host path
    jhost = jexp.pt2_correction(basis, vec, e)
    assert dev["exact"] and host["exact"]
    assert dev["de2"] <= 1e-12
    assert host["n_external"] == jhost["n_external"]
    assert abs(host["de2"] - jhost["de2"]) < DE2_TOL
    assert dev["n_external"] == host["n_external"]
    assert abs(dev["de2"] - host["de2"]) < DE2_TOL


def test_single_word_layout_unchanged():
    ham = _heis(pspin, 12, h_z=np.r_[0.1, np.zeros(11)])
    assert ham.pack_words == 1
    packed = (np.arange(40, dtype=np.uint32)[:, None] * 37 % 4096
              ).astype(np.uint32)
    conn, _ = ham.connections_np(packed)
    assert conn.shape == (40, len(ham.bonds), 1)
    for k in range(0, 40, 7):
        dref, _ = slow_heisenberg(ham, int(packed[k, 0]))
        assert ham.diagonal_np(packed[k:k + 1])[0] == \
            pytest.approx(dref, abs=1e-12)


def test_w2_unported_and_out_of_range_paths_raise():
    from flow_guided_krylov_torch.krylov.skqd import \
        SampleBasedKrylovDiagonalization
    from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                                   PipelineConfig)
    with pytest.raises(NotImplementedError):
        _heis(pspin, 65)
    with pytest.raises(NotImplementedError):
        pspin.TransverseFieldIsing(70, device="cpu")
    ham = _heis(pspin, 33, h_z=_hz(33))
    with pytest.raises(NotImplementedError, match="item 2 remainder"):
        SampleBasedKrylovDiagonalization(ham)
    with pytest.raises(NotImplementedError, match="item 2 remainder"):
        FlowGuidedKrylovPipeline(ham, PipelineConfig())
    with pytest.raises(NotImplementedError, match="n <= 31"):
        ham.full_diagonal_np()
    with pytest.raises(NotImplementedError, match="n <= 31"):
        ham.apply_statevector(torch.zeros(1), torch.zeros(1))
