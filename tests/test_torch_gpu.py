"""Port tests that need a CUDA card: the hand-written ELL SpMV kernel and
the slice on the device.  They skip without a card.

This file imports no JAX (the card's machine has none).  Run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_torch.hamiltonians import create_lih_hamiltonian
from flow_guided_krylov_torch.ops import ell_spmv as ell
from flow_guided_krylov_torch.ops.bits import to_device, to_host
from flow_guided_krylov_torch.utils.connection_table import \
    build_connection_table

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lih_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return create_lih_hamiltonian("cuda")


@pytest.fixture(scope="module")
def lih_ell(lih_cuda):
    t = build_connection_table(lih_cuda)
    return t.diag, t.elems.T.contiguous(), t.target_idx.T.contiguous()


def test_ell_kernel_matches_plain(lih_ell):
    diag, el_t, tgt_t = lih_ell
    gen = torch.Generator(device="cuda").manual_seed(1)
    psi = torch.randn(2, diag.shape[0], generator=gen, device="cuda")
    for x in (psi, psi[:1].contiguous(), psi[1].contiguous()):
        want = ell.ell_spmv_reference(diag, el_t, tgt_t, x)
        before = ell.ell_spmv_cuda.launches
        got = ell.ell_spmv(diag, el_t, tgt_t, x)
        torch.cuda.synchronize()
        assert ell.ell_spmv_cuda.launches == before + 1
        assert got.shape == x.shape
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_ell_wrapper_rejects_bad_input(lih_ell):
    diag, el_t, tgt_t = lih_ell
    psi = torch.zeros(3, diag.shape[0], device="cuda")
    with pytest.raises(ValueError, match="1 or 2"):
        ell.ell_spmv_cuda(diag, el_t, tgt_t, psi)
    with pytest.raises(ValueError, match="tgt_t"):
        ell.ell_spmv_cuda(diag, el_t, tgt_t.long(), psi[:2])
    with pytest.raises(ValueError, match="contiguous"):
        ell.ell_spmv_cuda(diag, el_t, tgt_t, psi[:2, ::1].T.contiguous().T)


def test_connections_on_card_match_host(lih_cuda):
    h = lih_cuda
    basis = h.enumerate_basis()
    conn, el = h.connections_device(to_device(basis, "cuda"))
    n_conn, n_el = h.connections_np(basis)
    np.testing.assert_array_equal(to_host(conn), n_conn)
    np.testing.assert_allclose(el.cpu().numpy(), n_el, rtol=0, atol=1e-5)
    d = h.diagonal_device(to_device(basis, "cuda")).cpu().numpy()
    np.testing.assert_allclose(d, h.diagonal_np(basis), rtol=0, atol=1e-4)


def test_slice_on_card(lih_cuda):
    """LiH stage 3 -> stage 4 with ELL evolution through the kernel."""
    from flow_guided_krylov_torch import krylov
    h = lih_cuda
    fci = h.fci_energy()
    sci = krylov.iterative_residual_expansion(
        h, h.get_hf_state()[None, :],
        krylov.ResidualExpansionConfig(configs_per_iteration=3,
                                       max_iterations=1))
    skqd = krylov.FlowGuidedSKQD(
        h, sci["basis"],
        krylov.SKQDConfig(evolution="ell", max_krylov_dim=6, time_step=0.5,
                          shots_per_krylov=200_000, seed=0))
    before = ell.ell_spmv_cuda.launches
    out = skqd.run_with_nf()
    assert ell.ell_spmv_cuda.launches > before
    assert fci - 1e-6 <= out["best_stable_energy"] <= sci["energy"] + 1e-12
    psi0 = np.zeros(skqd.dim, complex)
    psi0[skqd._index_of(h.get_hf_state())[0]] = 1.0
    assert np.abs(skqd.evolve(psi0) - skqd._evolve_scipy(psi0)).max() < 1e-5
