"""Port parity: the NQS models and flow pieces beyond the stage-1 pair —
``DenseNQS``'s activations, ``complex_output`` and bfloat16
``compute_dtype``, ``SignedDenseNQS``, ``ComplexNQS``, ``RBMQuantumState``,
``OrbitalScoringNetwork``, ``GumbelTopK`` and ``gumbel_topk(hard=False)``
— against the JAX package on the CPU, from one flax parameter tree each
(converted with ``flow_guided_krylov_torch.convert``) and seeded NumPy
inputs.  The reference's faults from flax's shared ``Dense_i`` names
(ROADMAP.md, Queue 3) are reproduced here, not repaired."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeParamNotFoundError

from flow_guided_krylov_tpu import models as jmodels
from flow_guided_krylov_tpu.flows import particle_conserving as jpc
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch import models as pmodels
from flow_guided_krylov_torch.flows import particle_conserving as ppc

torch.set_num_threads(1)

# float32 networks in two libraries: the same weights, another summation
# order; held relative to the output's largest magnitude
F32_RTOL = 1e-6
# bfloat16 hidden layers: 8 mantissa bits, rounded once a layer in each
# library (flax rounds after the product and again after the bias)
BF16_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _integral_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path / "integrals"))


def _x(n_sites, batch=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, n_sites)) < 0.4).astype(np.float32)


def _close(got: torch.Tensor, want, rtol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu", "silu"])
def test_dense_nqs_activations_match_flax(activation):
    """Every activation, flax's ``nn.gelu`` being the tanh approximation."""
    n, hidden = 12, (48, 32)
    jm = jmodels.DenseNQS(num_sites=n, hidden_dims=hidden,
                          activation=activation)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((2, n)))
    pm = pmodels.DenseNQS(n, hidden, activation=activation)
    pm.load_state_dict(convert.dense_nqs_state_dict(params))
    x = _x(n)
    _close(pm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)),
           F32_RTOL)


def test_dense_nqs_bfloat16_compute_matches_flax():
    """bfloat16 hidden layers, float32 output layer and result."""
    n, hidden = 20, (128, 128, 128)
    jm = jmodels.DenseNQS(num_sites=n, hidden_dims=hidden,
                          compute_dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(4), jnp.zeros((2, n)))
    pm = pmodels.DenseNQS(n, hidden, compute_dtype=torch.bfloat16)
    pm.load_state_dict(convert.dense_nqs_state_dict(params))
    x = _x(n, 256, seed=1)
    got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = jm.apply(params, jnp.asarray(x))
    assert want.dtype == jnp.float32
    _close(got, want, BF16_RTOL)
    # the bfloat16 trunk really runs: float32 of the same weights differs
    f32 = pmodels.DenseNQS(n, hidden)
    f32.load_state_dict(pm.state_dict())
    assert not torch.equal(f32(torch.from_numpy(x)), got)


def test_dense_nqs_complex_output_phase_is_the_head_before_tanh():
    """Reference fault (ROADMAP.md, Queue 3): flax shares ``Dense_i``
    between the two compact methods, so ``phase`` is the amplitude head
    before its tanh, arctanh(log|psi| / log_amp_scale)."""
    n, hidden = 10, (32, 32)
    jm = jmodels.DenseNQS(num_sites=n, hidden_dims=hidden,
                          complex_output=True)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((2, n)))
    assert sorted(params["params"]) == ["Dense_0", "Dense_1", "Dense_2",
                                        "log_amp_scale"]
    pm = pmodels.DenseNQS(n, hidden, complex_output=True)
    pm.load_state_dict(convert.dense_nqs_state_dict(params))
    x = _x(n, seed=2)
    jphase = jm.apply(params, jnp.asarray(x), method=jm.phase)
    _close(pm.phase(torch.from_numpy(x)), jphase, F32_RTOL)
    la = pm(torch.from_numpy(x)).detach()
    _close(torch.atanh(la / pm.log_amp_scale.detach()), jphase, 1e-5)
    # without complex_output the phase is zero in both
    jr = jmodels.DenseNQS(num_sites=n, hidden_dims=hidden)
    assert not np.asarray(jr.apply(params, jnp.asarray(x),
                                   method=jr.phase)).any()
    assert not pmodels.DenseNQS(n, hidden).phase(torch.from_numpy(x)).any()


def test_signed_dense_nqs_matches_flax_and_its_two_faults():
    """Amplitudes and phases equal; the sign is the amplitude head's
    (fault 1); parameters made through ``init(method=phase)`` lack
    ``log_amp_scale``, so flax's ``__call__`` raises and the port refuses
    a strict load of them (fault 2), while ``phase`` works in both."""
    n, hidden = 10, (24, 24)
    jm = jmodels.SignedDenseNQS(num_sites=n, hidden_dims=hidden)
    params = jm.init(jax.random.PRNGKey(6), jnp.zeros((2, n)))
    pm = pmodels.SignedDenseNQS(n, hidden)
    pm.load_state_dict(convert.dense_nqs_state_dict(params))
    x = _x(n, 128, seed=3)
    xt = torch.from_numpy(x)
    _close(pm(xt), jm.apply(params, jnp.asarray(x)), F32_RTOL)
    jphase = np.asarray(jm.apply(params, jnp.asarray(x), method=jm.phase))
    np.testing.assert_array_equal(pm.phase(xt).numpy(), jphase)
    assert set(np.unique(jphase)) <= {0.0, np.float32(math.pi)}
    head = pm.output_logits(xt).detach()
    np.testing.assert_array_equal(pm.phase(xt).numpy(),
                                  (math.pi * (head < 0).float()).numpy())
    _close(pm.sign_logits(xt),
           jm.apply(params, jnp.asarray(x), method=jm.sign_logits), F32_RTOL)

    phase_only = jm.init(jax.random.PRNGKey(7), jnp.zeros((2, n)),
                         method=jm.phase)
    assert "log_amp_scale" not in phase_only["params"]
    with pytest.raises(ScopeParamNotFoundError):
        jm.apply(phase_only, jnp.asarray(x))
    sd = convert.dense_nqs_state_dict(phase_only)
    assert "log_amp_scale" not in sd
    with pytest.raises(RuntimeError, match="log_amp_scale"):
        pmodels.SignedDenseNQS(n, hidden).load_state_dict(sd)
    loose = pmodels.SignedDenseNQS(n, hidden)
    loose.load_state_dict(sd, strict=False)
    np.testing.assert_array_equal(
        loose.phase(xt).numpy(),
        np.asarray(jm.apply(phase_only, jnp.asarray(x), method=jm.phase)))


@pytest.mark.parametrize("hidden", [(32, 32), (48, 24, 16)])
def test_complex_nqs_matches_flax(hidden):
    """Two heads off one GELU trunk (``Dense_k``, ``Dense_{k+1}``)."""
    n = 12
    jm = jmodels.ComplexNQS(num_sites=n, hidden_dims=hidden)
    params = jm.init(jax.random.PRNGKey(8), jnp.zeros((2, n)))
    k = len(hidden)
    assert sorted(params["params"]) == [f"Dense_{i}" for i in range(k + 2)]
    pm = pmodels.ComplexNQS(n, hidden)
    pm.load_state_dict(convert.complex_nqs_state_dict(params))
    x = _x(n, seed=4)
    xt = torch.from_numpy(x)
    _close(pm(xt), jm.apply(params, jnp.asarray(x)), F32_RTOL)
    _close(pm.phase(xt), jm.apply(params, jnp.asarray(x), method=jm.phase),
           F32_RTOL)
    la, ph = pm.amplitude_and_phase(xt)
    _close(la, jm.apply(params, jnp.asarray(x)), F32_RTOL)


@pytest.mark.parametrize("complex_weights", [False, True],
                         ids=["real", "complex"])
def test_rbm_matches_flax(complex_weights):
    """Real weights: the stable |z| + log1p(exp(-2|z|)) - log 2; complex:
    complex log cosh.  Weights scaled up from flax's normal(0.01) so the
    log cosh leaves its quadratic regime."""
    n, m = 10, 16
    jm = jmodels.RBMQuantumState(num_sites=n, n_hidden=m,
                                 complex_weights=complex_weights)
    params = jm.init(jax.random.PRNGKey(9), jnp.zeros((2, n)))
    params = jax.tree_util.tree_map(lambda p: 40.0 * p, params)
    pm = pmodels.RBMQuantumState(n, m, complex_weights=complex_weights)
    pm.load_state_dict(convert.rbm_state_dict(params))
    x = _x(n, seed=5)
    xt = torch.from_numpy(x)
    _close(pm(xt), jm.apply(params, jnp.asarray(x)), F32_RTOL)
    jphase = jm.apply(params, jnp.asarray(x), method=jm.phase)
    _close(pm.phase(xt), jphase, F32_RTOL)
    assert bool(np.asarray(jphase).any()) == complex_weights


def test_models_initialize_as_flax():
    """Zero phase by default, flax's initializers (LeCun-normal Dense,
    normal(0.01) RBM), and the JAX package's exports."""
    x = torch.from_numpy(_x(8))
    for m in (pmodels.DenseNQS(8, (16,)), pmodels.RBMQuantumState(8, 4)):
        assert isinstance(m, pmodels.NeuralQuantumState)
        assert not m.phase(x).any()
    rbm = pmodels.RBMQuantumState(64, 512, generator=torch.Generator()
                                  .manual_seed(0))
    assert abs(float(rbm.w.detach().std()) / 0.01 - 1.0) < 0.03
    c = pmodels.ComplexNQS(16, (256,))
    assert not c.dense[-1].bias.detach().any()
    assert sorted(pmodels.__all__) == sorted(jmodels.__all__)
    with pytest.raises(ValueError, match="activation"):
        pmodels.DenseNQS(8, (16,), activation="elu")


def _uniforms(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=1e-10,
                                         maxval=1.0))


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_gumbel_topk_and_its_object_match_jax(hard):
    """Fed JAX's own uniforms: the k-hot mask (hard) or the tempered
    softmax (soft), through the function and through ``GumbelTopK``."""
    rng = np.random.default_rng(6)
    B, n, k, temp = 32, 9, 3, 0.7
    logits = rng.normal(size=(B, n)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    u = torch.from_numpy(np.array(_uniforms(key, (B, n))))
    want = np.asarray(jpc.gumbel_topk(key, jnp.asarray(logits), k,
                                      jnp.float32(temp), hard))
    got = ppc.gumbel_topk(torch.from_numpy(logits), k,
                          float(np.float32(temp)), uniforms=u, hard=hard)
    obj = ppc.GumbelTopK(temp)(torch.from_numpy(logits), k, hard=hard,
                               uniforms=u)
    jobj = np.asarray(jpc.GumbelTopK(temp)(key, jnp.asarray(logits), k,
                                           hard))
    np.testing.assert_array_equal(want, jobj)
    for g in (got, obj):
        if hard:
            np.testing.assert_array_equal(np.round(g.numpy()),
                                          np.round(want))
            assert (np.round(g.numpy()).sum(-1) == k).all()
        else:
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)
            np.testing.assert_allclose(g.numpy().sum(-1), 1.0, atol=1e-6)


def test_orbital_scoring_network_matches_flax():
    """Context encoder -> scorer MLP -> logits, occupied orbitals at
    -inf; the prior broadcast without a context."""
    n_orb, hidden, ctx = 8, (32, 24), 16
    jm = jpc.OrbitalScoringNetwork(n_orbitals=n_orb, hidden_dims=hidden,
                                   context_dim=ctx)
    occ = _x(n_orb, 40, seed=7)
    params = jm.init(jax.random.PRNGKey(11), jnp.asarray(occ))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["prior_logits"] = np.linspace(
        -1, 1, n_orb).astype(np.float32)
    pm = ppc.OrbitalScoringNetwork(n_orb, hidden, ctx)
    pm.load_state_dict(convert.orbital_scorer_state_dict(params))
    want = np.asarray(jm.apply(params, jnp.asarray(occ)))
    got = pm(torch.from_numpy(occ)).detach().numpy()
    np.testing.assert_array_equal(np.isinf(got), occ > 0.5)
    np.testing.assert_array_equal(np.isinf(want), occ > 0.5)
    finite = ~np.isinf(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=F32_RTOL * max(1.0, np.abs(
                                   want[finite]).max()))
    prior = pm(None, batch_size=5).detach().numpy()
    np.testing.assert_array_equal(
        prior, np.asarray(jm.apply(params, None, 5)))
