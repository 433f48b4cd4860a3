"""Port tests that need a CUDA card: the hand-written ELL SpMV and x_sweep
kernels, and both slices on the device.  They skip without a card.

This file imports no JAX (the card's machine has none).  Run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from flow_guided_krylov_torch.hamiltonians import create_lih_hamiltonian
from flow_guided_krylov_torch.ops import ell_spmv as ell
from flow_guided_krylov_torch.ops import x_sweep as xs
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


@pytest.mark.parametrize("on_chip", [True, False], ids=["psi-in-smem",
                                                       "psi-in-l2"])
def test_ell_kernel_equals_segmented_plain(lih_ell, on_chip):
    """Both routes sum in the plain version's segmented order: 0.0."""
    diag, el_t, tgt_t = lih_ell
    gen = torch.Generator(device="cuda").manual_seed(2)
    psi = torch.randn(2, diag.shape[0], generator=gen, device="cuda")
    for x in (psi, psi[1].contiguous()):
        want = ell.ell_spmv_reference(diag, el_t, tgt_t, x)
        got = ell.ell_spmv_cuda(diag, el_t, tgt_t, x, psi_on_chip=on_chip)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) == 0.0


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


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _mixed_words(n, tile_bits):
    """Pure X on every tile bit, XX and YY on neighbouring tile bits, and a
    single Y whose Z mask reaches the top qubit, outside the tile."""
    words = [(0.01 * (q + 1), 1 << q, 0, 0) for q in range(tile_bits)]
    for q in range(0, tile_bits - 1, 3):
        m = (1 << q) | (1 << (q + 1))
        words += [(0.02 * (q + 1), m, 0, 0), (-0.03 * (q + 1), m, m, 2)]
    words.append((0.05, 1 << 2, (1 << 2) | (1 << (n - 1)), 1))
    return words


@pytest.mark.parametrize("tile_bits", [13, 14])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reversed"])
@pytest.mark.parametrize("n", [16, 20])
def test_x_sweep_kernel_matches_plain(card, n, reverse, tile_bits):
    """Same rounding, same order: the kernel equals the plain version."""
    gen = torch.Generator(device=card).manual_seed(n)
    re = torch.randn(1 << n, generator=gen, device=card)
    im = torch.randn(1 << n, generator=gen, device=card)
    words = _mixed_words(n, tile_bits)
    sweep = xs.make_x_sweep(n, words, tile_bits=tile_bits, reverse=reverse)
    before = xs.x_sweep_cuda.launches
    got = sweep(re, im)
    torch.cuda.synchronize()
    assert xs.x_sweep_cuda.launches == before + 1
    want = xs.x_sweep_reference(re, im, words[::-1] if reverse else words, n)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) == 0.0


def test_x_sweep_wrapper_rejects_bad_input(card):
    n = 14
    re = torch.zeros(1 << n, device=card)
    table = torch.as_tensor(xs.sweep_table(_mixed_words(n, 13), n, 13),
                            device=card)
    launches = xs.x_sweep_cuda.launches
    with pytest.raises(ValueError, match="re:"):
        xs.x_sweep_cuda(re.double(), re.double(), table, n, 13)
    with pytest.raises(ValueError, match="im"):
        xs.x_sweep_cuda(re, re[:-1], table, n, 13)
    with pytest.raises(ValueError, match="contiguous"):
        xs.x_sweep_cuda(re, torch.zeros(2 << n, device=card)[::2], table,
                        n, 13)
    with pytest.raises(ValueError, match="table"):
        xs.x_sweep_cuda(re, re, table.cpu(), n, 13)
    with pytest.raises(ValueError, match="table"):
        xs.x_sweep_cuda(re, re, table[:, :5].contiguous(), n, 13)
    with pytest.raises(ValueError, match="aligned"):
        xs.x_sweep_cuda(re, torch.zeros((1 << n) + 1, device=card)[1:],
                        table, n, 13)
    assert xs.x_sweep_cuda.launches == launches


def test_trotter_evolve_on_card_matches_cpu(card):
    """TFIM-18 with the default tile: the low words go through the kernel
    on the card and through the plain version on the CPU, in the same
    order.  Both take the half-phase's cos and sin in float64 on the host
    and round every product and sum alike, so the states are equal."""
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
    n, start = 18, 0
    out = {}
    for dev in ("cpu", "cuda"):
        s = krylov.SampleBasedKrylovDiagonalization(
            TransverseFieldIsing(n, h=0.5, device=dev),
            krylov.SKQDConfig(evolution="auto"),
            initial_state=np.array([start], np.uint32))
        assert s.use_trotter
        re = torch.zeros(1 << n, device=dev)
        re[start] = 1.0
        before = xs.x_sweep_cuda.launches
        plain = xs._pauli_rotation_pair.cuda_calls
        out[dev] = s._evolve_trotter(re, torch.zeros_like(re))
        launched = xs.x_sweep_cuda.launches - before
        # a substep: low sweep, one gathered sweep of the high words
        # (bits 14..17), low sweep reversed
        assert launched == (3 * s.config.num_trotter_steps
                            if dev == "cuda" else 0)
        assert xs._pauli_rotation_pair.cuda_calls == plain
    for c, g in zip(out["cpu"], out["cuda"]):
        assert float((g.cpu() - c).abs().max()) == 0.0


def test_sampler_draws_reproducibly_on_card(card):
    """The inverse-CDF sampler draws the same indices from the same
    uniforms, call after call, on 2^20 probabilities, and never a
    zero-probability index."""
    from flow_guided_krylov_torch.krylov import skqd
    gen = torch.Generator(device=card).manual_seed(3)
    prob = torch.rand(1 << 20, generator=gen, device=card) ** 4
    prob[::7] = 0.0
    u = torch.rand(100_000, generator=gen, device=card)
    first = skqd._sample_idx_cdf(prob, u)
    for _ in range(5):
        assert torch.equal(skqd._sample_idx_cdf(prob, u), first)
    assert float(prob[first].min()) > 0


def _straddling_words(n):
    """X on every bit above 13, XX and YY straddling bit 13|14 and later
    neighbours, and a Y whose Z mask reaches bit 0 and the top qubit."""
    words = [(0.01 * (q + 1), 1 << q, 0, 0) for q in range(13, n)]
    for q in range(13, n - 1, 2):
        m = (1 << q) | (1 << (q + 1))
        words += [(0.02 * q, m, 0, 0), (-0.03 * q, m, m, 2)]
    words.append((0.05, 1 << 15, (1 << 15) | 1 | (1 << (n - 1)), 1))
    return words


@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reversed"])
@pytest.mark.parametrize("n", [16, 20])
def test_gathered_sweeps_match_plain(card, n, reverse):
    """Gathered tiles over the high bits: one launch a planned group, the
    plain chain bit for bit, and no plain rotation on the card."""
    gen = torch.Generator(device=card).manual_seed(n + 1)
    re = torch.randn(1 << n, generator=gen, device=card)
    im = torch.randn(1 << n, generator=gen, device=card)
    words = _straddling_words(n)
    seq = words[::-1] if reverse else words
    for tile_bits in (8, 14):
        plan = xs.plan_sweeps(seq, n, tile_bits)
        before = xs.x_sweep_cuda.launches
        plain = xs._pauli_rotation_pair.cuda_calls
        got = xs.make_gathered_sweeps(n, seq, tile_bits)(re, im)
        torch.cuda.synchronize()
        assert xs.x_sweep_cuda.launches == before + len(plan)
        assert xs._pauli_rotation_pair.cuda_calls == plain
        want = xs.x_sweep_reference(re, im, seq, n)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) == 0.0


def test_heisenberg_evolve_on_card_matches_cpu(card):
    """Heisenberg-hx-20: XX/YY words cross bit 13|14, so the high words go
    through a gathered sweep.  The card's evolve equals the CPU's bit for
    bit and launches no plain rotation."""
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.hamiltonians import (HeisenbergHamiltonian,
                                                       pack_spin_state)
    n = 20
    neel = sum(1 << i for i in range(0, n, 2))
    out = {}
    for dev in ("cpu", "cuda"):
        s = krylov.SampleBasedKrylovDiagonalization(
            HeisenbergHamiltonian(n, 1.0, 1.0, 1.0, h_x=np.full(n, 0.3),
                                  device=dev),
            krylov.SKQDConfig(evolution="trotter"),
            initial_state=pack_spin_state(neel, n))
        re = torch.zeros(1 << n, device=dev)
        re[neel] = 1.0
        plain = xs._pauli_rotation_pair.cuda_calls
        out[dev] = s._evolve_trotter(re, torch.zeros_like(re))
        assert xs._pauli_rotation_pair.cuda_calls == plain
    for c, g in zip(out["cpu"], out["cuda"]):
        assert float((g.cpu() - c).abs().max()) == 0.0


def _wide_words(n):
    """Words that flip more than 4 bits between narrow ones, as in
    ``test_torch_sweep_plan.py``: a pure X on 5 bits, and X X Y Y X Y whose
    Z reaches bit 0 and the top qubit."""
    def mask(*qs):
        return sum(1 << q for q in qs)
    return [(0.11, 1 << 3, 0, 0), (0.07, mask(1, 4, 6, 9, 12), 0, 0),
            (-0.05, mask(2, 5, 7, 8, 10, 11), mask(7, 8, 11, 0, n - 1), 3),
            (0.02, mask(2, 5), mask(2, 5), 2)]


def _small_words(n):
    words = [(0.1 * (q + 1), 1 << q, 0, 0) for q in range(n)]
    return words + [(0.3, (1 << n) - 1, (1 << n) - 1, n % 4),
                    (-0.2, 1, (1 << n) - 1, 1)]


@pytest.mark.parametrize("n", [1, 3, 16])
def test_wide_words_and_small_states_match_plain(card, n):
    """Words of 5 and 6 flip bits (a register phase of their own) and
    states of fewer than 16 amplitudes (zero register vectors): the
    kernel equals the plain chain bit for bit, forward and reversed, on
    the contiguous tile and, at n = 16, on gathered 8-bit tiles."""
    gen = torch.Generator(device=card).manual_seed(n + 5)
    re = torch.randn(1 << n, generator=gen, device=card)
    im = torch.randn(1 << n, generator=gen, device=card)
    words = _wide_words(n) if n >= 13 else _small_words(n)
    for reverse in (False, True):
        seq = words[::-1] if reverse else words
        want = xs.x_sweep_reference(re, im, seq, n)
        sweeps = [xs.make_x_sweep(n, words, reverse=reverse)]
        if n >= 13:
            sweeps.append(xs.make_gathered_sweeps(n, seq, 8))
        for sweep in sweeps:
            before = xs.x_sweep_cuda.launches
            plain = xs._pauli_rotation_pair.cuda_calls
            got = sweep(re, im)
            torch.cuda.synchronize()
            assert xs.x_sweep_cuda.launches > before
            assert xs._pauli_rotation_pair.cuda_calls == plain
            for g, w in zip(got, want):
                assert float((g - w).abs().max()) == 0.0
