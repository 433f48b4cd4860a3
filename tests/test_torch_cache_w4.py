"""Port parity: the subspace trainers' dense projected H over 4-word
determinants (more than 32 orbitals) against the JAX package on the CPU.

The system is the 6-orbital (2a, 2b) one of ``tests/test_torch_skqd_w4.py``
scattered over orbitals 0, 1, 2, 31, 32 and 33 of 34 (W = 4, C = 5,216),
so that its determinants fill both words of each spin channel.  Held to:

* ``IncrementalHamiltonianCache`` through extend (50), extend (70),
  restrict and extend: the same basis as the JAX cache, the host float64
  ``H`` to ``HOST_H_RTOL`` and the device float32 ``H_device`` to
  ``DEVICE_H_RTOL`` of the largest |H_ij|; filled in chunks of new
  columns, bit for bit the one-chunk fill;
* ``InferenceNQSTrainer`` from one converted NQS: the same H, and the
  first epochs' energies to ``ENERGY_RTOL``.  The JAX trainer unpacks its
  occupations with the two-word ``unpack_np``, which at W = 4 reads the
  alpha channel's two words as alpha and beta (a fault of the reference,
  ROADMAP.md Queue 3); the comparison feeds it the true occupations;
* ``FlowNQSTrainer``: a raise naming its ROADMAP label.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.flows import training as jtr
from flow_guided_krylov_tpu.models import dense as jdense
from flow_guided_krylov_tpu.ops.bits import unpack_np as jax_unpack_np
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch.flows import particle_conserving as ppc
from flow_guided_krylov_torch.flows import training as ptr
from flow_guided_krylov_torch.models import dense as pdense
from flow_guided_krylov_torch.ops.bits import pack2_np, to_device, \
    unpack_device

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_multiword import _pair, _random_ints  # noqa: E402

torch.set_num_threads(1)

N_ORB = 34
ACTIVE = np.array([0, 1, 2, 31, 32, 33])
HOST_H_RTOL = 1e-6       # host float64 elements, the same formulas
DEVICE_H_RTOL = 1e-6     # float32 elements against float64, |H| ~ 3
ENERGY_RTOL = 2e-6       # float32 Rayleigh quotients in another order


@pytest.fixture(scope="module")
def system():
    ints6 = _random_ints(6, 2, 2, seed=7)
    h1 = np.zeros((N_ORB, N_ORB))
    h1[np.ix_(ACTIVE, ACTIVE)] = ints6["h1e"]
    h2 = np.zeros((N_ORB,) * 4)
    h2[np.ix_(ACTIVE, ACTIVE, ACTIVE, ACTIVE)] = ints6["h2e"]
    jh, ph = _pair(dict(ints6, h1e=h1, h2e=h2, n_orbitals=N_ORB))
    _, ph6 = _pair(ints6)
    full6 = ph6.enumerate_basis()
    occ = np.zeros((len(full6), 2, N_ORB), np.int64)
    for s in range(2):
        occ[:, s, ACTIVE] = (full6[:, s:s + 1] >> np.arange(6)) & 1
    basis = np.concatenate([pack2_np(occ[:, 0]), pack2_np(occ[:, 1])], -1)
    assert ph.pack_words == 4 and ph.n_connections == 5216
    assert basis[:, [0, 2]].any() and basis[:, [1, 3]].any()
    return jh, ph, basis, occ.reshape(len(basis), -1)


def test_w4_cache_matches_jax(system):
    jh, ph, basis, _ = system
    rng = np.random.default_rng(0)
    perm = basis[rng.permutation(len(basis))]
    keep = np.sort(rng.choice(120, 60, replace=False))
    jc = jtr.IncrementalHamiltonianCache(jh)
    pc = ptr.IncrementalHamiltonianCache(ph)
    for step in (lambda c: c.extend(perm[:50]),
                 lambda c: c.extend(perm[50:120]),
                 lambda c: c.restrict(keep),
                 lambda c: c.extend(perm[120:160])):
        step(jc)
        step(pc)
        np.testing.assert_array_equal(pc.basis, jc.basis)
        scale = float(np.abs(jc.H).max())
        np.testing.assert_allclose(pc.H, jc.H, rtol=0,
                                   atol=HOST_H_RTOL * scale)
        np.testing.assert_allclose(pc.H_device.double().numpy(), jc.H,
                                   rtol=0, atol=DEVICE_H_RTOL * scale)
    assert len(pc) == 100 and pc.peak_rows == 120
    assert pc.words.shape == (100, 4)
    np.testing.assert_array_equal(pc.words.numpy(),
                                  pc.basis.astype(np.int64))


def test_chunked_fill_equals_one_chunk(system):
    """The cache fills ``chunk_rows`` new columns at a time: 7 a time
    gives the one-chunk H bit for bit."""
    _, ph, basis, _ = system
    whole, parts = (ptr.IncrementalHamiltonianCache(ph) for _ in range(2))
    parts.chunk_rows = 7
    for c in (whole, parts):
        c.extend(basis[:40])
        c.extend(basis[40:100])
    assert whole.chunk_rows >= 60
    assert torch.equal(whole.H_device, parts.H_device)


def test_unpack_device_reads_both_words_of_a_channel(system):
    _, _, basis, occ = system
    np.testing.assert_array_equal(
        unpack_device(to_device(basis, "cpu"), N_ORB).numpy(), occ)
    # the JAX two-word unpack reads alpha's [hi, lo] as alpha and beta
    assert not np.array_equal(jax_unpack_np(basis, N_ORB), occ)


def test_w4_inference_trainer_matches_jax(system):
    jh, ph, basis, occ = system
    jt = jtr.InferenceNQSTrainer(
        jh, jdense.DenseNQS(num_sites=2 * N_ORB, hidden_dims=(16,)), basis,
        num_epochs=5)
    jt.occ = jnp.asarray(occ, jnp.float32)
    pt = ptr.InferenceNQSTrainer(ph, pdense.DenseNQS(2 * N_ORB, (16,)),
                                 basis, num_epochs=5)
    pt.nqs.load_state_dict(convert.dense_nqs_state_dict(jt.params))
    scale = float(np.abs(np.asarray(jt.H)).max())
    np.testing.assert_allclose(pt.H.double().numpy(), np.asarray(jt.H),
                               rtol=0, atol=DEVICE_H_RTOL * scale)
    np.testing.assert_array_equal(pt.occ.numpy(), occ)
    want = jt.train()["energies"]
    got = pt.train()["energies"]
    np.testing.assert_allclose(got, want, rtol=ENERGY_RTOL)
    e0 = float(np.linalg.eigvalsh(ph.matrix_elements(basis, basis))[0])
    assert min(got) >= e0 - 1e-5


def test_w4_flow_trainer_raises_naming_its_label(system):
    _, ph, _, _ = system
    flow = ppc.ParticleConservingFlow(N_ORB, 2, 2, hidden_dims=(8,))
    with pytest.raises(NotImplementedError, match=r"item 2 remainder \(c\)"):
        ptr.FlowNQSTrainer(ph, flow, pdense.DenseNQS(2 * N_ORB, (8,)))
