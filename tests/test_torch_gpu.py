"""Port tests that need a CUDA card: the hand-written ELL SpMV and x_sweep
kernels, the slices on the device, and the stage-1 step and pipeline on
the card against the CPU.  They skip without a card.

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


@pytest.mark.parametrize("n", [18, 20], ids=["tfim18", "tfim20"])
def test_trotter_evolve_on_card_matches_cpu(card, n):
    """TFIM-18 and TFIM-20 with the default tile: the words go through the
    kernel on the card (the half-phase inside the first and last launch)
    and through the plain version on the CPU, in the same order.  Both
    take the half-phase's cos and sin in float64 on the host and round
    every product and sum alike, so the states are equal."""
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
    start = 0
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
        # a substep: the commuting X's once each, the low ones on the
        # contiguous tile, the high ones (bits 14..n-1) on a gathered tile
        assert launched == (2 * s.config.num_trotter_steps
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


def _spin_skqd(model, n, device):
    """TFIM-n (h = 0.5) or Heisenberg-n with a transverse field and a
    longitudinal one on site 0 (the lattice CLI's two fields together),
    in Trotter mode (dt = 0.1, 8 substeps), and its start state."""
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.hamiltonians import (HeisenbergHamiltonian,
                                                       TransverseFieldIsing)
    if model == "tfim":
        h, start = TransverseFieldIsing(n, h=0.5, device=device), 0
    else:
        h_z = np.zeros(n)
        h_z[0] = 0.1
        h = HeisenbergHamiltonian(n, 1.0, 1.0, 1.0, h_x=np.full(n, 0.3),
                                  h_z=h_z, device=device)
        start = sum(1 << i for i in range(0, n, 2))
    s = krylov.SampleBasedKrylovDiagonalization(
        h, krylov.SKQDConfig(evolution="trotter"),
        initial_state=np.array([start], np.uint32))
    return s, start


def _diag_words(s):
    from flow_guided_krylov_torch.hamiltonians.spin import \
        extract_coeffs_and_paulis
    coeffs, words = extract_coeffs_and_paulis(s.h)
    return [(c, xs._pauli_masks(w)[1]) for c, w in zip(coeffs, words)
            if xs._pauli_masks(w)[0] == 0]


@pytest.mark.parametrize("model", ["tfim", "heisenberg_field"])
@pytest.mark.parametrize("n", [20, 24])
def test_fused_half_phase_on_card_equals_the_card_chain(card, monkeypatch,
                                                        n, model):
    """An evolve whose half-phases ride in the first and last sweep
    launches equals, bit for bit, the card's chain of 2^n tables
    (``_diag_mul`` -> sweeps -> ``_diag_mul``): TFIM and Heisenberg with
    a field (words past the contiguous tile, the hoisted order).  The
    card's class build equals the plain one, and one evolve counts
    ``trotter.phase_launches`` = 2 x 8 substeps and the build's classes,
    launches and, for TFIM, commuting words."""
    from torch.profiler import ProfilerActivity, profile
    from flow_guided_krylov_torch.krylov import skqd as skqd_mod
    from flow_guided_krylov_torch.utils import profiling
    fused, start = _spin_skqd(model, n, "cuda")
    diag = _diag_words(fused)
    phase = xs.half_phase_classes(diag, n, 0.1 / 8, card)
    plain = xs.half_phase_classes_reference(diag, n, 0.1 / 8, "cpu")
    assert phase.cls.dtype == plain.cls.dtype == torch.uint8
    assert phase.table.shape[0] == (n // 2 + 1 if model == "tfim" else 2 * n)
    assert torch.equal(phase.cls.cpu(), plain.cls)
    assert torch.equal(phase.table.cpu(), plain.table)
    re = torch.zeros(1 << n, device=card)
    re[start] = 1.0
    im = torch.zeros_like(re)
    before = xs.x_sweep_cuda.launches
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = fused._evolve_trotter(re, im)
            torch.cuda.synchronize()
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert xs.x_sweep_cuda.launches - before == 8 * len(fused._trotter.parts)
    assert len(fused._trotter.parts) > 1
    commuting = {"trotter.commuting_words": n} if model == "tfim" else {}
    assert counters == {"trotter.phase_launches": 2 * 8,
                        "trotter.phase_classes": phase.table.shape[0],
                        "trotter.substep_launches":
                            len(fused._trotter.parts), **commuting}
    monkeypatch.setattr(skqd_mod, "_fuses_half_phase", lambda device: False)
    chain, _ = _spin_skqd(model, n, "cuda")
    want = chain._evolve_trotter(re, im)
    assert not hasattr(chain._trotter, "parts")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_phase_launches_on_card_equal_plain(card):
    """Each launch variant against the plain version with the same phase,
    bit for bit, at n = 20: the phase after the load, before the store
    and both, with TFIM's and Heisenberg's classes, on a tile whose first
    register vectors are bits 0 and 1 (16-byte moves) and on one without
    them (4-byte moves); with ``at = 0`` the launch is the plain sweep."""
    n = 20
    gen = torch.Generator(device=card).manual_seed(7)
    re = torch.randn(1 << n, generator=gen, device=card)
    im = torch.randn(1 << n, generator=gen, device=card)
    words = _mixed_words(n, 14)
    phases = {}
    for model in ("tfim", "heisenberg_field"):
        s, _ = _spin_skqd(model, n, "cuda")
        phases[model] = xs.half_phase_classes(_diag_words(s), n, 0.1 / 8,
                                              card)
    shifted = tuple(range(2, 16))
    cases = [(words, 14), ([(0.1 * (q - 1), 1 << q, 0, 0) for q in shifted]
                           + [(0.2, 0b1100, 0b1100, 2)], shifted)]
    for seq, tile in cases:
        table = torch.as_tensor(xs.sweep_table(seq, n, tile), device=card)
        for phase in phases.values():
            for at in (0, xs.PHASE_LOAD, xs.PHASE_STORE,
                       xs.PHASE_LOAD | xs.PHASE_STORE):
                got = xs.x_sweep_cuda(re, im, table, n, tile, phase, at)
                want = xs.x_sweep_reference(re, im, seq, n, phase, at)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (tile, at,
                                               phase.table.shape[0])


def test_phase_build_on_card_falls_back_past_the_cap(card, monkeypatch):
    """Distinct random longitudinal fields on 17 sites (131,024 angles):
    the card's build gives None, as the plain one does; the cap lowered
    refuses one class short of TFIM-20's 11."""
    from flow_guided_krylov_torch.hamiltonians import HeisenbergHamiltonian
    from flow_guided_krylov_torch.krylov.skqd import \
        SampleBasedKrylovDiagonalization, SKQDConfig
    n = 17
    rng = np.random.default_rng(0)
    h = HeisenbergHamiltonian(n, 1.0, 1.0, 1.0, h_x=np.full(n, 0.3),
                              h_z=rng.uniform(-1, 1, n), device="cuda")
    s = SampleBasedKrylovDiagonalization(
        h, SKQDConfig(evolution="trotter"),
        initial_state=np.array([0], np.uint32))
    assert xs.half_phase_classes(_diag_words(s), n, 0.1 / 8, card) is None
    assert not hasattr(s._trotter_ops(), "parts")
    tfim, _ = _spin_skqd("tfim", 20, "cuda")
    diag = _diag_words(tfim)
    monkeypatch.setattr(xs, "MAX_PHASE_CLASSES", 10)
    assert xs.half_phase_classes(diag, 20, 0.1 / 8, card) is None
    monkeypatch.setattr(xs, "MAX_PHASE_CLASSES", 11)
    assert xs.half_phase_classes(diag, 20, 0.1 / 8, card).table.shape \
        == (11, 2)


def test_fused_evolve_memory_on_card(card):
    """n = 24: over a build and one evolve the allocator's peak, above
    the start pair the caller holds, stays under the state pair a launch
    reads, the pair it writes and the class index, and 5 %: no 2^n
    table, no 2^n temporary of the build."""
    n = 24
    s, start = _spin_skqd("tfim", n, "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    re = torch.zeros(1 << n, device=card)
    re[start] = 1.0
    im = torch.zeros_like(re)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = s._evolve_trotter(re, im)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    pair = 2 * 4 << n
    assert s._trotter.parts and s._trotter.parts[0].keywords["phase"] \
        .cls.dtype == torch.uint8
    assert peak <= 1.05 * (2 * pair + (1 << n)), peak
    del out


def _stage1_trainer(h, device_kw=None):
    from flow_guided_krylov_torch.flows import (ParticleConservingFlow,
                                                PhysicsGuidedConfig,
                                                PhysicsGuidedFlowTrainer)
    from flow_guided_krylov_torch.models import DenseNQS
    n = h.n_orbitals
    cfg = PhysicsGuidedConfig(samples_per_batch=256, verbose=False, seed=4,
                              num_epochs=20, **(device_kw or {}))
    return PhysicsGuidedFlowTrainer(
        h, ParticleConservingFlow(n, h.n_alpha, h.n_beta, (64, 64)),
        DenseNQS(2 * n, (64, 64)), cfg)


@pytest.mark.parametrize("route", ["dense", "table", "fly"])
def test_stage1_steps_on_card_match_cpu(lih_cuda, route):
    """The same samples and priorities through three steps on the card
    and on the CPU: f32-close metrics, the same accumulated basis."""
    kw = {"dense": {}, "table": {"dense_local_energy_max_dim": 0},
          "fly": {"use_connection_table": False}}[route]
    cpu = _stage1_trainer(create_lih_hamiltonian("cpu"), kw)
    card = _stage1_trainer(lih_cuda, kw)
    assert cpu.route == card.route == route
    for step in range(3):
        configs = cpu.sample(cpu.temperature_at(step))
        pri = torch.rand(cpu._acc_keys.shape[0] + configs.shape[0],
                         generator=torch.Generator().manual_seed(step))
        a = cpu.update(configs, priorities=pri)
        b = card.update(configs.cuda(), priorities=pri.cuda()).cpu()
        assert (a[:4] - b[:4]).abs().max() <= 2e-5
        assert torch.equal(a[4:], b[4:])
        assert torch.equal(card._acc_keys.cpu(), cpu._acc_keys)


def test_pipeline_on_card(lih_cuda):
    from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                                   PipelineConfig)
    cfg = PipelineConfig(max_epochs=80, min_epochs=30, samples_per_batch=256,
                         nqs_hidden_dims=[64, 64], nf_hidden_dims=[64, 64],
                         verbose=False)
    pipe = FlowGuidedKrylovPipeline(lih_cuda, cfg,
                                    exact_energy=lih_cuda.fci_energy())
    out = pipe.run()
    assert pipe.trainer._acc_keys.is_cuda
    assert abs(out["error_mha"]) < 1.6 and out["nf_basis_size"] == 225


# ---------------------------------------------------------------------------
# Sector and restricted tables, the device eigensolvers and the exact dE2
# ---------------------------------------------------------------------------

def _sector_skqd(n, device, **cfg):
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.hamiltonians import HeisenbergHamiltonian
    h = HeisenbergHamiltonian(n, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * (n - 1)),
                              device=device)
    neel = np.array([sum(1 << i for i in range(0, n, 2))], np.uint32)
    return krylov.SampleBasedKrylovDiagonalization(
        h, krylov.SKQDConfig(**cfg), initial_state=neel)


@pytest.mark.parametrize("b", [1, 2])
def test_ell_kernel_on_a_sector_table_one_segment_through_l2(card, b):
    """The Heisenberg-22 sector (705,432 x 21): past 2^18 rows a row is
    one segment, and psi is far past shared memory, so each lane gathers
    through L2.  Same order as the plain version: 0.0."""
    s = _sector_skqd(22, card)
    diag, el_t, tgt_t = s._ell_structure()
    c, n = el_t.shape
    assert ell.ell_segments(n, c) == 1 and not ell.psi_fits_on_chip(n, b)
    gen = torch.Generator(device=card).manual_seed(b)
    psi = torch.randn(b, n, generator=gen, device=card)
    want = ell.ell_spmv_reference(diag, el_t, tgt_t, psi)
    got = ell.ell_spmv(diag, el_t, tgt_t, psi)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) == 0.0


def test_ell_kernel_on_a_wide_synthetic_table(card):
    """20,000 rows of 2,835 random connections, the row degree of
    N2/cc-pVDZ (10e, 14o): 0.0 against the plain version on both routes
    of B = 1 and through L2 at B = 2."""
    n, c = 20_000, 2835
    gen = torch.Generator(device=card).manual_seed(9)
    diag = torch.randn(n, generator=gen, device=card)
    el_t = torch.randn(c, n, generator=gen, device=card)
    tgt_t = torch.randint(0, n, (c, n), generator=gen, device=card,
                          dtype=torch.int32)
    for b, routes in ((1, (True, False)), (2, (True, False))):
        psi = torch.randn(b, n, generator=gen, device=card)
        want = ell.ell_spmv_reference(diag, el_t, tgt_t, psi)
        for on_chip in routes:
            got = ell.ell_spmv_cuda(diag, el_t, tgt_t, psi,
                                    psi_on_chip=on_chip)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) == 0.0


def test_build_ell_device_on_card_matches_cpu(card, lih_cuda):
    """Sector and restricted tables built on the card against the CPU's:
    targets equal, float32 elements and diagonals to 1e-6."""
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.krylov.skqd import \
        build_restricted_subspace
    pairs = [(_sector_skqd(12, card), _sector_skqd(12, "cpu"))]
    cpu = create_lih_hamiltonian("cpu")
    sci = krylov.iterative_residual_expansion(
        cpu, cpu.get_hf_state()[None, :],
        krylov.ResidualExpansionConfig(configs_per_iteration=6,
                                       max_iterations=2))
    states = build_restricted_subspace(cpu, sci["basis"], 100,
                                       initial_state=cpu.get_hf_state())
    pairs.append(tuple(krylov.FlowGuidedSKQD(
        h, sci["basis"], krylov.SKQDConfig(), subspace_states=states)
        for h in (lih_cuda, cpu)))
    for on_card, on_cpu in pairs:
        got = on_card._build_ell_device(on_card.subspace, chunk=37)
        want = on_cpu._build_ell_device(on_cpu.subspace)
        assert all(t.is_cuda and t.is_contiguous() for t in got)
        assert torch.equal(got[2].cpu(), want[2])
        for a, b in zip(got[:2], want[:2]):
            assert float((a.cpu() - b).abs().max()) <= 1e-6


def test_sector_skqd_and_oracle_on_card(card):
    """Heisenberg-16 sector SKQD through ``auto`` (dense at 12,870
    states) and ``ell``, and the device oracle against the host's."""
    s = _sector_skqd(16, card, evolution="ell", max_krylov_dim=4,
                     shots_per_krylov=20_000, lanczos_dim=12)
    before = ell.ell_spmv_cuda.launches
    out = s.run(final_only=True)
    assert ell.ell_spmv_cuda.launches == before + 3 * 12
    exact = float(s.h.exact_ground_state(s.subspace, k=1)[0][0])
    before = ell.ell_spmv_cuda.launches
    e_dev = s.exact_subspace_energy(refine_host=False)
    assert ell.ell_spmv_cuda.launches > before
    assert abs(e_dev - exact) < 1e-4
    assert exact - 1e-6 <= out["final_energy"] < -3.7


def test_fullspace_ground_state_on_card(card, monkeypatch):
    """Both routes of the full 2^16 space, each chosen by the memory the
    budget reports: the card's own (tables fit), then 64 MiB (only the
    table-free flips fit)."""
    from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
    from flow_guided_krylov_torch.postprocessing.eigensolver import \
        exact_fullspace_ground_state
    from flow_guided_krylov_torch.utils import memory
    n = 16
    ham = TransverseFieldIsing(n, V=1.0, h=1.0, device=card)
    k = (2 * np.arange(n) + 1) * np.pi / n
    exact = float(-np.sum(np.sqrt(2.0 - 2.0 * np.cos(k))))
    for route in ("ell-fused", "flip-stepped"):
        if route == "flip-stepped":
            monkeypatch.setattr(memory, "device_memory_bytes",
                                lambda device: 64 << 20)
        before = ell.ell_spmv_cuda.launches
        out = exact_fullspace_ground_state(ham, refine_host=False,
                                           use_cache=False, verbose=False)
        assert out["route"] == route
        assert abs(out["energy"] - exact) < 1e-4
        assert (ell.ell_spmv_cuda.launches > before) == (route
                                                         == "ell-fused")


def test_pt2_correction_on_card_is_reproducible(lih_cuda):
    """Two device dE2 runs agree bit for bit (no float atomics) and with
    the host closure to 1e-6 Ha."""
    from flow_guided_krylov_torch import krylov
    h = lih_cuda
    sci = krylov.iterative_residual_expansion(
        h, h.get_hf_state()[None, :],
        krylov.ResidualExpansionConfig(configs_per_iteration=8,
                                       max_iterations=2, max_basis_size=20))
    vals, vecs = h.exact_ground_state(sci["basis"], k=1)
    e, coeffs = float(vals[0]), vecs[:, 0]
    exp = krylov.SelectedCIExpander(h)
    a = exp.pt2_correction(sci["basis"], coeffs, e)
    b = exp.pt2_correction(sci["basis"], coeffs, e)
    assert a == b and a["exact"]
    host = exp._pt2_correction_host(sci["basis"], coeffs, e)
    assert abs(a["de2"] - host["de2"]) < 1e-6
    blk = krylov.SelectedCIExpander(h)
    blk._pt2_row_cap = 16                     # blocks of 64 rows stay one
    assert blk.pt2_correction(sci["basis"], coeffs, e) == a


# ---------------------------------------------------------------------------
# The device PT2 scorer and the spin pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["heisenberg16", "lih"])
def test_pt2_scorer_on_card_is_reproducible(card, model):
    """Two device scorings of one basis agree bit for bit (stable sort and
    segment_reduce, no float atomics), and rank the host scorer's
    candidates: one-word spin words and two-word determinants."""
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.hamiltonians import HeisenbergHamiltonian
    if model == "lih":
        h = create_lih_hamiltonian("cuda")
        start = h.get_hf_state()[None, :]
    else:
        h = HeisenbergHamiltonian(16, 1.0, 1.0, 1.0,
                                  h_z=np.array([0.1] + [0.0] * 15),
                                  device="cuda")
        start = np.array([[sum(1 << i for i in range(0, 16, 2))]], np.uint32)
    cfg = krylov.ResidualExpansionConfig(configs_per_iteration=40,
                                         max_iterations=3,
                                         max_basis_size=2000)
    basis = krylov.iterative_residual_expansion(h, start, cfg)["basis"]
    dev = krylov.SelectedCIExpander(h, cfg, use_device_scoring=True)
    host = krylov.SelectedCIExpander(h, cfg, use_device_scoring=False)
    e, coeffs = host._diagonalize(basis)
    a = dev._pt2_topk_device(basis, coeffs)
    b = dev._pt2_topk_device(basis, coeffs)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    cand_d, sc_d = dev._pt2_candidates(basis, coeffs, e)
    cand_h, sc_h = host._pt2_candidates(basis, coeffs, e)
    assert np.array_equal(h.keys(cand_d), h.keys(cand_h))
    np.testing.assert_allclose(sc_d, sc_h, rtol=1e-4, atol=1e-12)


def test_spin_pipeline_on_card(card):
    """The spin pipeline on the card: Heisenberg-12 through the S_z flow
    and its sector, stage 1 on the card, every energy variational."""
    from flow_guided_krylov_torch.hamiltonians import HeisenbergHamiltonian
    from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                                   PipelineConfig)
    h = HeisenbergHamiltonian(12, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * 11),
                              device="cuda")
    e_exact = float(np.linalg.eigvalsh(h.exact_dense())[0])
    pipe = FlowGuidedKrylovPipeline(h, PipelineConfig(
        max_epochs=40, min_epochs=10, samples_per_batch=256,
        nqs_hidden_dims=[64, 64], max_krylov_dim=3, shots_per_krylov=5000,
        verbose=False), exact_energy=e_exact)
    out = pipe.run()
    assert next(pipe.trainer.nqs.parameters()).is_cuda
    assert type(pipe.flow).__name__ == "SzConservingFlow"
    for key in ("nf_energy", "residual_energy", "final_energy"):
        assert out[key] >= e_exact - 1e-9, key
    assert abs(out["error_mha"]) < 1.6


# ---------------------------------------------------------------------------
# Multiword: 4-word determinants (33..64 orbitals), two-word spin chains
# ---------------------------------------------------------------------------

def _embedded34(device, seed):
    """A 6-orbital random system (``synthetic_integrals``) zero-padded into
    34 orbitals: 4-word rows whose extra virtuals couple to nothing."""
    from flow_guided_krylov_torch.hamiltonians import (MolecularHamiltonian,
                                                       synthetic_integrals)
    small = synthetic_integrals(6, 2, 2, seed)
    h1 = np.zeros((34, 34))
    h1[:6, :6] = small.h1e
    h2 = np.zeros((34,) * 4)
    h2[:6, :6, :6, :6] = small.h2e
    small.h1e, small.h2e, small.n_orbitals = h1, h2, 34
    return MolecularHamiltonian(small, device)


def _multiword_state(card, model):
    """(Hamiltonian on the card, a Selected-CI basis, its ground state)."""
    from flow_guided_krylov_torch import krylov
    from flow_guided_krylov_torch.hamiltonians import (HeisenbergHamiltonian,
                                                       pack_spin_state)
    if model == "embedded34":
        h = _embedded34("cuda", seed=11)
        start = h.get_hf_state()[None, :]
    else:
        h = HeisenbergHamiltonian(33, 1.0, 1.0, 1.0,
                                  h_z=np.array([0.1] + [0.0] * 32),
                                  device="cuda")
        start = pack_spin_state(sum(1 << i for i in range(0, 33, 2)),
                                33)[None, :]
    cfg = krylov.ResidualExpansionConfig(configs_per_iteration=40,
                                         max_iterations=3,
                                         max_basis_size=300)
    basis = krylov.iterative_residual_expansion(h, start, cfg)["basis"]
    exp = krylov.SelectedCIExpander(h, cfg)
    e, coeffs = exp._diagonalize(basis)
    return h, cfg, basis, coeffs, e


def test_w2_connections_on_card_match_host(card):
    """The 4-word connection function on the card: targets bit for bit,
    float32 elements to 2e-5 and the float64 form to 1e-12 of the host
    f64 mirror, at 35 orbitals (the JAX package's w2 test system)."""
    from flow_guided_krylov_torch.hamiltonians import \
        create_synthetic_hamiltonian
    from flow_guided_krylov_torch.ops.slater import make_connection_fn_w2
    h = create_synthetic_hamiltonian(35, 2, 2, "cuda", seed=3)
    assert h.pack_words == 4
    hf = h.get_hf_state()[None, :]
    conn, el = h.connections_np(hf)
    batch = np.concatenate([hf, conn[0][np.abs(el[0]) > 1e-10][:40]])
    c_np, e_np = h.connections_np(batch)
    rows = to_device(batch, "cuda")
    c_d, e_d = h.connections_device(rows)
    assert np.array_equal(to_host(c_d), c_np)
    assert np.max(np.abs(e_d.cpu().numpy() - e_np)) < 2e-5
    c64, e64 = make_connection_fn_w2(h.tables, "cuda",
                                     dtype=torch.float64)(rows)
    assert np.array_equal(to_host(c64), c_np)
    assert np.max(np.abs(e64.cpu().numpy() - e_np)) < 1e-12
    d64 = h.diagonal_device(rows, dtype=torch.float64).cpu().numpy()
    assert np.max(np.abs(d64 - h.diagonal_np(batch))) < 1e-12


def test_w2_scorer_on_card_is_reproducible(card):
    """Two device scorings of a 4-word basis (key pairs, two stable
    sorts, segment_reduce) agree bit for bit and give the host scorer's
    candidates."""
    from flow_guided_krylov_torch import krylov
    h, cfg, basis, coeffs, e = _multiword_state(card, "embedded34")
    dev = krylov.SelectedCIExpander(h, cfg, use_device_scoring=True)
    host = krylov.SelectedCIExpander(h, cfg, use_device_scoring=False)
    a = dev._pt2_topk_device(basis, coeffs)
    b = dev._pt2_topk_device(basis, coeffs)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    cand_d, sc_d = dev._pt2_candidates(basis, coeffs, e)
    cand_h, sc_h = host._pt2_candidates(basis, coeffs, e)
    assert h.keys(cand_d).tobytes() == h.keys(cand_h).tobytes()
    np.testing.assert_allclose(sc_d, sc_h, rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("model", ["embedded34", "heisenberg33"])
def test_multiword_de2_on_card_matches_host(card, model):
    """The exact dE2 on the card (4-word rows: the multiword blocks with
    float64 elements and denominators; 33 sites: the one-key block)
    against the host f64 path to 1e-8 Ha, twice bit for bit."""
    from flow_guided_krylov_torch import krylov
    h, cfg, basis, coeffs, e = _multiword_state(card, model)
    exp = krylov.SelectedCIExpander(h, cfg)
    a = exp.pt2_correction(basis, coeffs, e)
    b = exp.pt2_correction(basis, coeffs, e)
    assert a == b and a["exact"]
    host = exp._pt2_correction_host(basis, coeffs, e)
    assert a["n_external"] == host["n_external"]
    assert abs(a["de2"] - host["de2"]) < 1e-8


# ---------------------------------------------------------------------------
# The entry points on the card
# ---------------------------------------------------------------------------

def test_bench_line_on_card(card, monkeypatch, tmp_path):
    """``bench``'s one JSON line on the card, with ``bench.py``'s keys;
    the walls to chemical accuracy on LiH and H2O (the N2 and CH4 FCI
    oracles take a minute on the host, ``chip_smoke.py`` runs those)."""
    import json
    from flow_guided_krylov_torch.examples import bench
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    tta = bench.time_to_accuracy
    monkeypatch.setattr(bench, "time_to_accuracy",
                        lambda m, device: tta({"n2": "lih",
                                               "ch4": "h2o"}[m], device))
    line = bench.bench("cuda")
    assert list(line) == list(bench.BENCH_KEYS)
    assert line["kernel"] == "ops/slater.py::make_connection_fn"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    for m in ("n2", "ch4"):
        assert line[f"{m}_time_to_chemacc_s"] is not None
        assert line[f"{m}_error_mha"] < 1.6
    json.dumps(line)


def test_pt2_only_run_on_card_equals_cpu(card, monkeypatch, tmp_path):
    from flow_guided_krylov_torch.examples import benchmark
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    got = benchmark.pt2_only_run("lih", device="cuda")
    want = benchmark.pt2_only_run("lih", device="cpu")
    assert got["nf_basis_size"] == want["nf_basis_size"]
    assert abs(got["final_energy"] - want["final_energy"]) < 1e-8
    assert got["chemical_accuracy"]


@pytest.mark.parametrize("model,n,h", [("tfim", 12, 0.5),
                                       ("heisenberg", 12, 0.1),
                                       ("heisenberg", 15, 0.1)])
def test_exact_oracle_equal_on_both_devices(card, model, n, h):
    """The lattice CLI's oracle is host code on either device's
    Hamiltonian: the Pauli-word build to 14 sites, ``eigsh`` above."""
    from flow_guided_krylov_torch.examples import \
        skqd_lattice_validation as lat
    e = {dev: lat.exact_oracle(lat.make_hamiltonian(model, n, h, dev)[0])
         for dev in ("cuda", "cpu")}
    assert abs(e["cuda"] - e["cpu"]) < 1e-10


def _models_pair():
    """Each NQS model of the port and the scorer, at small widths, and a
    way to run both copies: (name, cpu model, forward)."""
    from flow_guided_krylov_torch.flows import OrbitalScoringNetwork
    from flow_guided_krylov_torch.models import (ComplexNQS, DenseNQS,
                                                 RBMQuantumState,
                                                 SignedDenseNQS)
    g = torch.Generator().manual_seed(5)
    return [
        ("dense_gelu", DenseNQS(20, (64, 64), activation="gelu",
                                generator=g), 2e-6),
        ("dense_bf16", DenseNQS(20, (64, 64), generator=g,
                                compute_dtype=torch.bfloat16), 2e-2),
        ("dense_complex", DenseNQS(20, (64, 64), complex_output=True,
                                   generator=g), 2e-6),
        ("signed", SignedDenseNQS(20, (64, 64), generator=g), 2e-6),
        ("complex", ComplexNQS(20, (64, 64), generator=g), 2e-6),
        ("rbm", RBMQuantumState(20, 32, generator=g), 2e-6),
        ("rbm_complex", RBMQuantumState(20, 32, complex_weights=True,
                                        generator=g), 2e-6),
        ("scorer", OrbitalScoringNetwork(20, (64, 64), 16, generator=g),
         2e-6)]


@pytest.mark.parametrize("index", range(8))
def test_new_models_on_card_match_cpu(card, index):
    """Log-amplitudes and phases (the scorer: its logits, -inf on the
    occupied orbitals) on the card against the CPU, f32 (bf16 trunk:
    2e-2) of the largest magnitude."""
    import copy
    name, cpu, tol = _models_pair()[index]
    dev = copy.deepcopy(cpu).to(card)
    x = (torch.rand(4000, 20, generator=torch.Generator().manual_seed(6))
         < 0.4).float()
    with torch.no_grad():
        outs = [(cpu(x), dev(x.to(card)).cpu())]
        if hasattr(cpu, "phase"):
            outs.append((cpu.phase(x), dev.phase(x.to(card)).cpu()))
    for a, b in outs:
        finite = torch.isfinite(a)
        assert torch.equal(finite, torch.isfinite(b)), name
        scale = max(1.0, float(a[finite].abs().max()))
        assert float((a[finite] - b[finite]).abs().max()) <= tol * scale, name


def test_subspace_step_on_card_matches_cpu(lih_cuda):
    """One FlowNQSTrainer step from one basis and one state on the card
    and on the CPU: the energy, the flow loss and the updated NQS to
    f32; the device H to f32."""
    from flow_guided_krylov_torch.flows import (FlowNQSTrainer,
                                                ParticleConservingFlow,
                                                TrainingConfig)
    from flow_guided_krylov_torch.models import DenseNQS

    def make(h):
        return FlowNQSTrainer(h, ParticleConservingFlow(6, 2, 2, (64, 64)),
                              DenseNQS(12, (64, 64)),
                              TrainingConfig(samples_per_batch=256, seed=3))
    cpu, dev = make(create_lih_hamiltonian("cpu")), make(lih_cuda)
    basis = cpu.h.enumerate_basis()[::2]
    cpu.cache.extend(basis)
    dev.cache.extend(basis)
    assert (cpu.cache.H_device - dev.cache.H_device.cpu()).abs().max() \
        <= 1e-6 * 8.0
    e_c, f_c = cpu._step()
    e_d, f_d = dev._step()
    assert abs(float(e_c) - float(e_d)) <= 2e-6 * abs(float(e_c))
    assert abs(float(f_c) - float(f_d)) <= 2e-6 * max(1.0, abs(float(f_c)))
    for a, b in zip(cpu.nqs.parameters(), dev.nqs.parameters()):
        assert (a.detach() - b.detach().cpu()).abs().max() <= 0.05 * 1e-3


# ---------------------------------------------------------------------------
# The row-block ELL kernel and the mesh on the card (a logical mesh of
# four cuda:0 entries)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2])
def test_row_block_kernel_equals_plain(lih_ell, b):
    """Row blocks through the row-block kernel: each equal to its plain
    version and their concatenation to the square kernel, bit for bit, on
    both routes."""
    diag, el_t, tgt_t = lih_ell
    n = diag.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    psi = torch.randn(b, n, generator=gen, device="cuda")
    cuts = (0, 1, n // 3, n // 2 + 7, n)
    for on_chip in (True, False):
        parts = []
        for a, z in zip(cuts[:-1], cuts[1:]):
            d = diag[a:z].contiguous()
            e = el_t[:, a:z].contiguous()
            t = tgt_t[:, a:z].contiguous()
            before = ell.ell_spmv_cuda.launches
            got = ell.ell_spmv_cuda(d, e, t, psi, psi_on_chip=on_chip,
                                    row0=a)
            torch.cuda.synchronize()
            assert ell.ell_spmv_cuda.launches == before + 1
            want = ell.ell_spmv_reference(d, e, t, psi, a)
            assert torch.equal(got, want)
            parts.append(got)
        assert torch.equal(torch.cat(parts, -1),
                           ell.ell_spmv_cuda(diag, el_t, tgt_t, psi))
    with pytest.raises(ValueError, match="leave"):
        ell.ell_spmv_cuda(diag[:8].contiguous(), el_t[:, :8].contiguous(),
                          tgt_t[:, :8].contiguous(), psi, row0=n - 4)


def test_sharded_ell_evolve_on_card_is_bit_equal(card):
    """Heisenberg-16's S_z = 0 sector over a logical mesh of four cuda:0
    entries: the sharded ELL evolve equals the unsharded one bit for bit,
    through the row-block kernel."""
    from flow_guided_krylov_torch.hamiltonians import HeisenbergHamiltonian
    from flow_guided_krylov_torch.krylov import (
        SampleBasedKrylovDiagonalization, SKQDConfig)
    from flow_guided_krylov_torch.parallel import make_mesh
    hz = np.zeros(16)
    hz[0] = 0.1
    h = HeisenbergHamiltonian(16, 1.0, 1.0, 1.0, h_z=hz, device="cuda")
    neel = np.array([sum(1 << i for i in range(0, 16, 2))], np.uint32)
    cfg = SKQDConfig(evolution="ell")
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    one = SampleBasedKrylovDiagonalization(h, cfg, initial_state=neel)
    sk = SampleBasedKrylovDiagonalization(h, cfg, initial_state=neel,
                                          mesh=mesh)
    psi = np.zeros(sk.dim, complex)
    psi[sk._index_of(neel)[0]] = 1.0
    before = ell.ell_spmv_cuda.launches
    out = sk.evolve(psi)
    assert ell.ell_spmv_cuda.launches > before
    assert np.array_equal(out, one.evolve(psi))


def test_sharded_trotter_block_tables_on_card(card, monkeypatch):
    """TFIM-16 over four blocks on the card: the per-block x_sweep tables
    (the Z bits above the block folded into theta) give the plain
    rotations' bits, block by block, and the sharded substep the
    single-device one's on the mesh's word list (the single device's own
    list, each commuting X once at full angle, to float32 rounding)."""
    from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
    from flow_guided_krylov_torch.krylov import (
        SampleBasedKrylovDiagonalization, SKQDConfig, skqd)
    from flow_guided_krylov_torch.parallel import (gather_statevector,
                                                   make_mesh,
                                                   make_sharded_substep,
                                                   shard_statevector)
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    n, shift = 16, 14
    dt = 0.05
    terms = [(0.4 * (q + 1), 1 << q, (1 << 15) | (1 << 3), q % 4)
             for q in range(shift)]
    words = [(c * dt / 2, xm, zm, ny) for c, xm, zm, ny in terms]
    gen = torch.Generator(device="cuda").manual_seed(4)
    v = torch.randn(2, 1 << n, generator=gen, device="cuda")
    step, hr, hi = make_sharded_substep(mesh, n, [(0.3, 1 << 15)], terms,
                                        dt)
    ones = [torch.ones_like(h_) for h_ in hr]
    zeros = [torch.zeros_like(h_) for h_ in hi]
    re, im = shard_statevector(mesh, v[0].contiguous(), v[1].contiguous())
    before = xs.x_sweep_cuda.launches
    gr, gi = gather_statevector(mesh, *step(re, im, ones, zeros))
    torch.cuda.synchronize()
    assert xs.x_sweep_cuda.launches > before
    seq = words + words[::-1]
    wr, wi = xs.x_sweep_reference(v[0].contiguous(), v[1].contiguous(),
                                  seq, n)
    assert torch.equal(gr, wr) and torch.equal(gi, wi)
    h = TransverseFieldIsing(16, h=0.5, device="cuda")
    cfg = SKQDConfig(evolution="trotter", num_trotter_steps=2)
    init = np.array([0], np.uint32)
    own = SampleBasedKrylovDiagonalization(h, cfg, initial_state=init)
    one = SampleBasedKrylovDiagonalization(h, cfg, initial_state=init)
    sk = SampleBasedKrylovDiagonalization(h, cfg, initial_state=init,
                                          mesh=mesh)
    r0, i0 = own._evolve_trotter(v[0].contiguous(), v[1].contiguous())
    monkeypatch.setattr(skqd, "_substep_words", lambda offd, dt: (
        skqd._half_angle_words(offd, dt), False))
    r1, i1 = one._evolve_trotter(v[0].contiguous(), v[1].contiguous())
    r2, i2 = gather_statevector(mesh, *sk._evolve_trotter(
        *shard_statevector(mesh, v[0].contiguous(), v[1].contiguous())))
    assert (r1 - r2).abs().max() <= 1e-6 and (i1 - i2).abs().max() <= 1e-6
    assert (r0 - r2).abs().max() <= 1e-5 and (i0 - i2).abs().max() <= 1e-5


def test_w4_cache_on_card_matches_cpu(card):
    """``IncrementalHamiltonianCache`` over 4-word determinants (a
    2-orbital pair scattered over orbitals 31 and 33 of 34, so both words
    of each channel carry bits) through extend, restrict and extend: the
    card's float32 H against the CPU's, to 1e-6 of the largest |H_ij|,
    and ``InferenceNQSTrainer``'s H the same."""
    from flow_guided_krylov_torch.chem.scf import MolecularIntegrals
    from flow_guided_krylov_torch.flows import (IncrementalHamiltonianCache,
                                                InferenceNQSTrainer)
    from flow_guided_krylov_torch.hamiltonians import MolecularHamiltonian
    from flow_guided_krylov_torch.models import DenseNQS
    from flow_guided_krylov_torch.tools import random_determinants
    rng = np.random.default_rng(5)
    n, act = 34, np.array([0, 1, 2, 31, 32, 33])
    h1 = np.zeros((n, n))
    a = rng.normal(size=(6, 6))
    h1[np.ix_(act, act)] = 0.5 * (a + a.T)
    g = rng.normal(size=(6,) * 4) * 0.1
    g = g + g.transpose(1, 0, 2, 3)
    g = g + g.transpose(0, 1, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)
    h2 = np.zeros((n,) * 4)
    h2[np.ix_(act, act, act, act)] = g / 8
    ints = MolecularIntegrals(h1e=h1, h2e=h2, nuclear_repulsion=0.5,
                              n_electrons=4, n_orbitals=n, n_alpha=2,
                              n_beta=2)
    hc, hg = (MolecularHamiltonian(ints, d) for d in ("cpu", "cuda"))
    basis = random_determinants(hc, 120, seed=3)
    caches = [IncrementalHamiltonianCache(h) for h in (hc, hg)]
    for c in caches:
        c.extend(basis[:50])
        c.extend(basis[50:])
        c.restrict(np.arange(0, 120, 2))
        c.extend(basis[1::2])
    want = caches[0].H_device.double().numpy()
    got = caches[1].H_device.double().cpu().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    tr = InferenceNQSTrainer(hg, DenseNQS(2 * n, (16,)), basis,
                             num_epochs=3)
    ref = InferenceNQSTrainer(hc, DenseNQS(2 * n, (16,)), basis,
                              num_epochs=3)
    assert (tr.H.double().cpu() - ref.H.double()).abs().max() \
        <= 1e-6 * ref.H.abs().max()
    assert np.isfinite(tr.train()["energies"]).all()


def test_tools_time_on_card(card):
    """The tools' timings are taken on the card: the roofline's variants
    and a PT2 block at small sizes carry a time, launches and a card
    name."""
    from flow_guided_krylov_torch.tools import card as card_name
    from flow_guided_krylov_torch.tools import repro_pt2_block as rp
    from flow_guided_krylov_torch.tools import roofline_connection as rc
    assert "," in card_name(card)
    h = create_lih_hamiltonian("cuda")
    m = rc.measure(h, h.enumerate_basis(), card, reps=2)
    assert all(v["ms"] > 0 and v["launches"] > 0
               for v in m["variants"].values())
    r = rp.run_block(h, 64, iters=2)
    assert r["ms"] > 0 and r["first_call_s"] > 0


# E_loc of N2 (10e, 10o) is ~ -109 Ha, summed over 875 float32 elements
# times float32 ratios, in another summation order on each device: 2e-6
# of the largest |E_loc| (~2.2e-4 Ha), as tests/test_torch_stage1_table.py
# holds the table route to float64
TABLE_ELOC_RTOL = 2e-6


def test_table_local_energies_n2_10o_on_card_match_cpu(card):
    """N2/cc-pVDZ (10e, 10o), the benchmark's ``n2-ccpvdz-10o``: the
    trainer takes the connection table (dense cap 0, as one H100's
    51,548 is below 63,504), on seeded random weights at the published
    widths (NQS 6 x 512, flow 2 x 384); one batch's local energies on the
    card against the CPU's."""
    from flow_guided_krylov_torch.examples.large_system_benchmark import \
        SYSTEMS
    from flow_guided_krylov_torch.flows.particle_conserving import \
        ParticleConservingFlow
    from flow_guided_krylov_torch.flows.physics_guided_training import (
        PhysicsGuidedConfig, PhysicsGuidedFlowTrainer)
    from flow_guided_krylov_torch.models.dense import DenseNQS
    from flow_guided_krylov_torch.ops.bits import unpack_np
    out = {}
    for dev in ("cpu", "cuda"):
        h = SYSTEMS["n2_ccpvdz_10o"](dev)
        assert (h.n_valid_configs, h.n_connections) == (63504, 875)
        tr = PhysicsGuidedFlowTrainer(
            h, ParticleConservingFlow(10, 5, 5, (384, 384)),
            DenseNQS(20, (512,) * 6),
            PhysicsGuidedConfig(samples_per_batch=32,
                                connection_table_max_entries=63504 * 875,
                                dense_local_energy_max_dim=0, seed=7,
                                verbose=False))
        assert tr.route == "table"
        basis = h.enumerate_basis()
        rng = np.random.default_rng(3)
        packed = basis[np.sort(rng.choice(len(basis), 32, replace=False))]
        occ = torch.from_numpy(unpack_np(packed, 10)).float().to(dev)
        with torch.no_grad():
            out[dev] = tr.local_energies(to_device(packed, dev),
                                         tr.nqs(occ)).double().cpu().numpy()
    assert np.isfinite(out["cuda"]).all()
    np.testing.assert_allclose(
        out["cuda"], out["cpu"], rtol=0,
        atol=TABLE_ELOC_RTOL * np.abs(out["cpu"]).max())
