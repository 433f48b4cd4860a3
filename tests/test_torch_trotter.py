"""Port parity: the x_sweep plain version, Pauli rotations, the Trotter
propagator and spin SKQD in Trotter mode, against the JAX package on the
CPU.

The CUDA kernel itself runs only on a card: see ``test_torch_gpu.py``.
On the CPU, ``make_x_sweep``'s callable runs ``x_sweep_reference``.  The
JAX sweep is the Pallas kernel in interpret mode, as
``tests/test_pallas_spmv.py`` runs it.

Tolerances: one rotation is float32 arithmetic in both packages; the port
takes cos and sin in float64 and rounds them (as the Pallas kernel does),
where the JAX rotation takes them in float32.  Sweeps agree to about 1e-8
and are held to the JAX test's 2e-6; single rotations are held to 1e-6.
A Trotter evolve chains 8 substeps of up to 68 rotations; the two
packages' states differed by 0.9e-6 (TFIM-12) and 1.7e-6
(Heisenberg-hx-12), and are held to 1e-5.  At 12 sites every word lies
inside the sweep's tile of 2^14 amplitudes; at 16 sites the words that
flip bit 14 or 15 leave it for the plain rotations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_tpu.krylov.basis_sampler import \
    _apply_pauli_rotation as jax_rotation
from flow_guided_krylov_tpu.ops.pallas_trotter import \
    make_x_sweep as jax_make_x_sweep
from flow_guided_krylov_torch.convert import spin_hamiltonian_from_jax
from flow_guided_krylov_torch.krylov import skqd
from flow_guided_krylov_torch.ops import x_sweep as xs

torch.set_num_threads(1)

N = 12
# pure X single bit, lane-bit X, XX, YY with z, and a single Y (n_y = 1)
WORDS = [(0.07, 1 << 3, 0, 0),
         (-0.11, 1 << 9, 0, 0),
         (0.05, (1 << 2) | (1 << 8), 0, 0),
         (0.09, (1 << 1) | (1 << 5), (1 << 1) | (1 << 5), 2),
         (0.13, 1 << 4, 1 << 4, 1)]


def _state(n, seed):
    rng = np.random.default_rng(seed)
    re = rng.normal(size=1 << n).astype(np.float32)
    im = rng.normal(size=1 << n).astype(np.float32)
    nrm = np.sqrt((re ** 2 + im ** 2).sum())
    return re / nrm, im / nrm


@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reversed"])
def test_plain_sweep_matches_pallas_kernel(reverse):
    """block_rows=8 is a tile of 8 * 128 = 2^10 amplitudes."""
    re0, im0 = _state(N, 3)
    jsweep = jax_make_x_sweep(N, WORDS, block_rows=8, reverse=reverse,
                              interpret=True)
    psweep = xs.make_x_sweep(N, WORDS, tile_bits=10, reverse=reverse)
    assert jsweep is not None and psweep is not None
    jr, ji = jsweep(jnp.asarray(re0), jnp.asarray(im0))
    pr, pi = psweep(torch.as_tensor(re0), torch.as_tensor(im0))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=2e-6)
    # the callable is the plain version on the CPU, word by word
    seq = WORDS[::-1] if reverse else WORDS
    rr, ri = xs.x_sweep_reference(torch.as_tensor(re0), torch.as_tensor(im0),
                                  seq, N)
    assert torch.equal(rr, pr) and torch.equal(ri, pi)
    assert xs.x_sweep_cuda.launches == 0


def test_masks_outside_the_tile_give_none():
    for mask in (1 << 10, 1 << 11, 0):
        word = [(0.1, mask, 0, 0)]
        assert xs.make_x_sweep(N, word, tile_bits=10) is None
        if mask:
            assert jax_make_x_sweep(N, word, block_rows=8,
                                    interpret=True) is None
    # the tile is 2^min(tile_bits, n): at n = 6 every mask below 64 fits
    assert xs.make_x_sweep(6, [(0.1, 63, 0, 0)], tile_bits=14) is not None


def test_word_table_layout():
    table = xs.word_table(WORDS)
    assert table.dtype == np.int32 and table.shape == (5, 5)
    cs = table[:, :2].copy().view(np.float32)
    np.testing.assert_array_equal(
        cs, np.array([xs._cos_sin_f32(w[0]) for w in WORDS], np.float32))
    np.testing.assert_array_equal(table[:, 2:],
                                  [[w[1], w[2], w[3] % 4] for w in WORDS])


def test_cuda_wrapper_refuses_cpu_tensors():
    re0, im0 = (torch.as_tensor(a) for a in _state(N, 0))
    table = torch.as_tensor(xs.word_table(WORDS))
    with pytest.raises(ValueError, match="CUDA"):
        xs.x_sweep_cuda(re0, im0, table, N, 10)
    with pytest.raises(ValueError, match="tile_bits"):
        xs.x_sweep_cuda(re0, im0, table, N, 15)
    with pytest.raises(ValueError, match="no x_sweep"):
        xs.make_x_sweep(N, WORDS, tile_bits=10)(re0.to("meta"),
                                                im0.to("meta"))
    assert xs.x_sweep_cuda.launches == 0


@pytest.mark.parametrize("word", WORDS + [(-0.2, 1 << 11, 1 << 7, 0),
                                          (0.3, 0b101, 0b110, 3)],
                         ids=["x", "x_high", "xx", "yy", "y", "xz", "xyz"])
def test_pauli_rotation_matches_jax(word):
    theta, xm, zm, ny = word
    re0, im0 = _state(N, 5)
    jr, ji = jax_rotation(jnp.asarray(re0), jnp.asarray(im0),
                          jnp.float32(theta), xm, zm, ny, N)
    pr, pi = xs._pauli_rotation_pair(torch.as_tensor(re0),
                                     torch.as_tensor(im0), theta, xm, zm, ny,
                                     N)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=1e-6)
    assert pr.dtype == torch.float32


def _tfim(n):
    return jspin.TransverseFieldIsing(n, V=1.0, h=0.5), 0


def _heisenberg_hx(n):
    return (jspin.HeisenbergHamiltonian(n, 1.0, 1.0, 1.0,
                                        h_x=np.full(n, 0.3),
                                        h_z=0.05 * np.arange(n)),
            sum(1 << i for i in range(0, n, 2)))


JAX_MODELS = {"tfim": _tfim, "heisenberg_hx": _heisenberg_hx}


def _skqd_pair(model, n):
    """(JAX SKQD, port SKQD, start) in Trotter mode, 8 substeps of
    dt = 0.1 / 8."""
    jh, start = JAX_MODELS[model](n)
    cfg = dict(time_step=0.1, num_trotter_steps=8, evolution="trotter")
    init = np.array([start], np.uint32)
    js = jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(**cfg), initial_state=init)
    ps = skqd.SampleBasedKrylovDiagonalization(
        spin_hamiltonian_from_jax(jh, "cpu"), skqd.SKQDConfig(**cfg),
        initial_state=init)
    assert js.use_trotter and ps.use_trotter and ps.subspace is None
    return js, ps, start


@pytest.fixture(scope="module", params=["heisenberg_hx12", "tfim12"])
def trotter_pair(request):
    return _skqd_pair(request.param[:-2], N)


@pytest.fixture(scope="module", params=["heisenberg_hx16", "tfim16"])
def hoisted_pair(request):
    return _skqd_pair(request.param[:-2], 16)


def _start_pair(ps, start):
    re = torch.zeros(ps.dim)
    re[start] = 1.0
    return re, torch.zeros(ps.dim)


def test_half_phase_matches_jax(trotter_pair):
    js, ps, _ = trotter_pair
    _, j_hr, j_hi = js._trotter_ops()
    from flow_guided_krylov_torch.hamiltonians.spin import \
        extract_coeffs_and_paulis
    coeffs, words = extract_coeffs_and_paulis(ps.h)
    diag = [(c, xs._pauli_masks(w)[1]) for c, w in zip(coeffs, words)
            if xs._pauli_masks(w)[0] == 0]
    hr, hi = skqd._half_phase(diag, N, 0.1 / 8, "cpu")
    np.testing.assert_allclose(hr.numpy(), np.asarray(j_hr), rtol=0,
                               atol=2e-7)
    np.testing.assert_allclose(hi.numpy(), np.asarray(j_hi), rtol=0,
                               atol=2e-7)


def test_half_phase_is_rounded_float64(trotter_pair):
    """Each state's half-phase is the float64 cos and -sin of its float32
    angle, rounded to float32, whatever the device's own ``cos``."""
    _, ps, _ = trotter_pair
    from flow_guided_krylov_torch.hamiltonians.spin import \
        extract_coeffs_and_paulis
    coeffs, words = extract_coeffs_and_paulis(ps.h)
    diag = [(c, xs._pauli_masks(w)[1]) for c, w in zip(coeffs, words)
            if xs._pauli_masks(w)[0] == 0]
    k = np.arange(1 << N)
    D = np.zeros(1 << N, np.float32)
    for c, zm in diag:
        parity = np.array([bin(v).count("1") & 1 for v in k & zm])
        D = D + np.float32(c) * (1 - 2 * parity).astype(np.float32)
    ang = (np.float32(0.5 * 0.1 / 8) * D).astype(np.float64)
    hr, hi = skqd._half_phase(diag, N, 0.1 / 8, "cpu")
    np.testing.assert_array_equal(hr.numpy(), np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(hi.numpy(),
                                  -np.sin(ang).astype(np.float32))


def test_trotter_evolve_matches_jax_fused(trotter_pair):
    """n <= TILE_BITS: every word goes through the sweep, in the JAX
    package's fused-substep order."""
    js, ps, start = trotter_pair
    assert N <= xs.TILE_BITS
    re, im = _start_pair(ps, start)
    jre = jnp.zeros(js.dim, jnp.float32).at[start].set(1.0)
    jr, ji = js._evolve_trotter(jre, jnp.zeros(js.dim, jnp.float32))
    pr, pi = ps._evolve_trotter(re, im)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=1e-5)


def test_trotter_evolve_hoisted_order_matches_jax(hoisted_pair):
    """n = 16 > TILE_BITS = 14: words that flip bit 14 or 15 leave the
    sweep, so the substep is diag . low . high . reversed(high) .
    reversed(low) . diag.  The JAX side is the same composition of its
    rotations."""
    js, ps, start = hoisted_pair
    n = ps.h.n_sites
    _, hr, hi = js._trotter_ops()
    from flow_guided_krylov_tpu.krylov.basis_sampler import _pauli_masks
    coeffs, words = jspin.extract_coeffs_and_paulis(js.h)
    dt = 0.1 / 8
    offd = [(c * dt / 2,) + _pauli_masks(w) for c, w in zip(coeffs, words)
            if _pauli_masks(w)[0] != 0]
    low = [w for w in offd if w[1] < 1 << xs.TILE_BITS]
    high = [w for w in offd if w[1] >= 1 << xs.TILE_BITS]
    assert low and high
    r = jnp.zeros(js.dim, jnp.float32).at[start].set(1.0)
    i = jnp.zeros(js.dim, jnp.float32)
    for _ in range(8):
        r, i = r * hr - i * hi, r * hi + i * hr
        for theta, xm, zm, ny in low + high + high[::-1] + low[::-1]:
            r, i = jax_rotation(r, i, jnp.float32(theta), xm, zm, ny, n)
        r, i = r * hr - i * hi, r * hi + i * hr
    pr, pi = ps._evolve_trotter(*_start_pair(ps, start))
    np.testing.assert_allclose(pr.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pi.numpy(), np.asarray(i), rtol=0, atol=1e-5)


def _exact_evolved(h, psi0, t):
    """exp(-i t H) psi0 in float64: dense up to 8 sites, sparse beyond."""
    if h.n_sites <= 8:
        import scipy.linalg
        return scipy.linalg.expm(-1j * t * h.exact_dense()) @ psi0
    import scipy.sparse.linalg as spla
    states = np.arange(1 << h.n_sites, dtype=np.uint32)[:, None]
    return spla.expm_multiply(-1j * t * h.to_sparse(states), psi0)


@pytest.mark.parametrize("build,start", [
    (lambda: jspin.TransverseFieldIsing(8, V=1.0, h=0.8), 0),
    (lambda: jspin.HeisenbergHamiltonian(7, 1.0, 1.0, 0.9,
                                         h_z=0.1 * np.ones(7)),
     sum(1 << i for i in range(0, 7, 2))),
    (lambda: jspin.TransverseFieldIsing(16, V=1.0, h=0.8), 0),
    (lambda: jspin.HeisenbergHamiltonian(16, 1.0, 1.0, 0.9,
                                         h_x=np.full(16, 0.3)),
     sum(1 << i for i in range(0, 16, 2))),
], ids=["tfim8-all_low", "heisenberg7-all_low", "tfim16-hoisted",
        "heisenberg_hx16-hoisted"])
def test_trotter_matches_exact_propagator(build, start):
    """As ``tests/test_spin.py``: 16 substeps of the statevector Trotter
    propagator reach exp(-i dt H)|psi> to fidelity 0.9999, with every
    word in the sweep (n <= TILE_BITS) and with some outside it."""
    h = spin_hamiltonian_from_jax(build(), "cpu")
    s = skqd.SampleBasedKrylovDiagonalization(
        h, skqd.SKQDConfig(time_step=0.1, num_trotter_steps=16,
                           evolution="trotter"),
        initial_state=np.array([start], np.uint32))
    assert s.use_trotter and s.subspace is None
    re, im = s._evolve_trotter(*_start_pair(s, start))
    psi = re.numpy().astype(complex) + 1j * im.numpy()
    psi0 = np.zeros(s.dim, complex)
    psi0[start] = 1.0
    fidelity = abs(np.vdot(_exact_evolved(h, psi0, 0.1),
                           psi / np.linalg.norm(psi)))
    assert fidelity > 0.9999, f"Trotter fidelity {fidelity}"


def test_two_level_cdf_matches_jax_across_rows():
    """The sampler's cdf in rows of 4096 draws what JAX's one cumsum
    draws, on 10,000 small-integer probabilities (3 rows, the last one
    padded; every sum exact in float32), and draws it again from the same
    uniforms."""
    import jax
    rng = np.random.default_rng(5)
    prob = rng.integers(0, 4, size=10_000).astype(np.float32)
    prob[[0, 4095, 4096, 8191, 9999]] = 0.0
    key = jax.random.PRNGKey(2)
    want = np.asarray(jskqd._sample_idx_cdf(key, jnp.asarray(prob), 20_000))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (20_000,))))
    got = skqd._sample_idx_cdf(torch.tensor(prob), u)
    np.testing.assert_array_equal(got.numpy(), want)
    assert prob[got.numpy()].min() > 0
    assert torch.equal(skqd._sample_idx_cdf(torch.tensor(prob), u), got)


def test_trotter_auto_routing_threshold():
    """evolution='auto' picks the statevector path above the threshold and
    the subspace path below it; the subspace H is then never built."""
    small = skqd.SampleBasedKrylovDiagonalization(
        spin_hamiltonian_from_jax(jspin.TransverseFieldIsing(8, h=0.5),
                                  "cpu"), skqd.SKQDConfig())
    assert not small.use_trotter and small.subspace is not None
    big = skqd.SampleBasedKrylovDiagonalization(
        spin_hamiltonian_from_jax(jspin.TransverseFieldIsing(18, h=0.5),
                                  "cpu"),
        skqd.SKQDConfig(trotter_threshold=17))
    assert big.use_trotter and big.subspace is None and big.dim == 1 << 18
    with pytest.raises(RuntimeError, match="Trotter mode"):
        big.subspace_hamiltonian
    with pytest.raises(RuntimeError, match="_evolve_trotter"):
        big.evolve(np.zeros(4, complex))


def test_tfim10_trotter_skqd_end_to_end():
    """TFIM-10, h = 0.5, K = 10, 20k shots, Trotter mode, in both packages.

    The two packages draw from different RNG streams (torch.Generator and
    jax.random), so their samples differ.  Fed identical sample dicts,
    their cumulative bases and eigensolves agree to 1e-9 Ha; each
    package's own run is variational and under 1.6 mHa."""
    jh = jspin.TransverseFieldIsing(10, V=1.0, h=0.5)
    h = spin_hamiltonian_from_jax(jh, "cpu")
    e_exact = np.linalg.eigh(h.exact_dense())[0][0]
    cfg = dict(max_krylov_dim=10, shots_per_krylov=20_000, time_step=0.1,
               seed=3, evolution="trotter")
    init = np.array([0], np.uint32)
    js = jskqd.SampleBasedKrylovDiagonalization(
        jh, jskqd.SKQDConfig(**cfg), initial_state=init)
    ps = skqd.SampleBasedKrylovDiagonalization(
        h, skqd.SKQDConfig(**cfg), initial_state=init)
    j_out, p_out = js.run(), ps.run()
    for out in (j_out, p_out):
        err = 1000 * (out["final_energy"] - e_exact)
        assert -1e-6 <= err < 1.6, err
        assert len(out["energies"]) == 10
        assert sum(out["samples"][0].values()) == 20_000
    assert p_out["samples"][0] == {0: 20_000}
    for samples in (j_out["samples"], p_out["samples"]):
        jb = js.build_cumulative_basis(samples)
        pb = ps.build_cumulative_basis(samples)
        for a, b in zip(jb, pb):
            np.testing.assert_array_equal(a, b)
        for b in pb[::3] + pb[-1:]:
            assert abs(ps.compute_ground_state_energy(b)
                       - js.compute_ground_state_energy(b)) < 1e-9
    final_only = ps.run(final_only=True)
    assert np.isnan(final_only["energies"][0])
    assert np.isfinite(final_only["final_energy"])
