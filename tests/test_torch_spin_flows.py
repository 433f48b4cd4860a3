"""Port parity: the spin flows (``SzConservingFlow``, ``DiscreteFlowSampler``)
against the JAX package on the CPU, fed the same parameters (through
``convert``) and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.flows import discrete as jdisc
from flow_guided_krylov_tpu.flows import particle_conserving as jpc
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch.flows import discrete as pdisc
from flow_guided_krylov_torch.flows import particle_conserving as ppc

torch.set_num_threads(1)

# float32 log-probs and flow values in another summation order: 1e-5,
# absolute and relative (a RealNVP output grows by exp(+/-2) a layer)
TOL = dict(rtol=1e-5, atol=1e-5)
PROB_RTOL = 1e-4     # the importance-sampled p(x), exp of a logsumexp
# probabilities below float32's smallest normal number: the JAX package's
# CPU backend may flush them to 0
TINY = 1.2e-38


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sz_pair(n=10, n_up=5, seed=0):
    jf = jpc.SzConservingFlow(n_sites=n, n_up=n_up)
    key = jax.random.PRNGKey(seed)
    params = jf.init(key, key, 2, method=jf.sample)
    rng = np.random.default_rng(seed)
    params = {"params": {"site_logits": jnp.asarray(
        rng.normal(size=n).astype(np.float32))}}
    pf = ppc.SzConservingFlow(n, n_up)
    pf.load_state_dict(convert.sz_flow_state_dict(_np_tree(params)))
    return jf, params, pf


def _disc_pair(n=8, hidden=16, seed=0):
    jf = jdisc.DiscreteFlowSampler(n_sites=n, hidden=hidden)
    key = jax.random.PRNGKey(seed)
    params = jf.init(key, key, 2, method=jf.sample)
    pf = pdisc.DiscreteFlowSampler(n, hidden=hidden)
    pf.load_state_dict(convert.discrete_flow_state_dict(_np_tree(params)))
    return jf, params, pf


def test_sz_flow_sample_is_bit_equal_given_the_noise():
    jf, params, pf = _sz_pair()
    key = jax.random.PRNGKey(4)
    occ, lp = jf.apply(params, key, 64, method=jf.sample)
    u = _t(jax.random.uniform(key, (64, 10), minval=1e-10, maxval=1.0))
    got, glp = pf.sample(64, noise=u)
    np.testing.assert_array_equal(torch.round(got).detach().numpy(),
                                  np.round(np.asarray(occ)))
    assert (torch.round(got).sum(-1) == 5).all()
    np.testing.assert_allclose(glp.detach().numpy(), np.asarray(lp),
                               **TOL)


def test_sz_flow_log_prob_and_probability_match_jax():
    jf, params, pf = _sz_pair(n=12, n_up=6, seed=1)
    rng = np.random.default_rng(2)
    configs = np.zeros((40, 12), np.float32)
    for row in configs:
        row[rng.choice(12, 6, replace=False)] = 1.0
    key = jax.random.PRNGKey(0)
    want = np.asarray(jf.apply(params, key, jnp.asarray(configs),
                               method=jf.log_prob))
    got = pf.log_prob(torch.from_numpy(configs)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    p = pf.estimate_discrete_prob(torch.from_numpy(configs)).detach().numpy()
    jp = np.asarray(jf.apply(params, key, jnp.asarray(configs), 0,
                             method=jf.estimate_discrete_prob))
    np.testing.assert_allclose(p, jp, rtol=PROB_RTOL, atol=0)


def test_discrete_flow_round_trip_and_continuous_log_prob():
    jf, params, pf = _disc_pair()
    rng = np.random.default_rng(3)
    z = (np.sign(rng.normal(size=(50, 8)))
         + 0.5 * rng.normal(size=(50, 8))).astype(np.float32)
    jy, jld = jf.apply(params, jnp.asarray(z), method=jf.forward)
    y, ld = pf.forward(torch.from_numpy(z))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), **TOL)
    back, ild = pf.inverse(y)
    jback, _ = jf.apply(params, jy, method=jf.inverse)
    np.testing.assert_allclose(back.detach().numpy(), np.asarray(jback),
                               **TOL)
    # the round trip itself: float32 rounding grows by exp(|s|) a layer
    np.testing.assert_allclose(back.detach().numpy(), z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ild.detach().numpy(), -ld.detach().numpy(),
                               **TOL)
    # log-density of the flow's own outputs (random y far from the flow's
    # mass gives log-densities of -6e4, where float32 keeps 4 digits)
    want = np.asarray(jf.apply(params, jy, method=jf.continuous_log_prob))
    got = pf.continuous_log_prob(_t(jy)).detach().numpy()
    # the inverse's rounding scales with the batch's largest term, as the
    # stage-1 tests hold local energies
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_discrete_flow_sample_matches_jax_given_the_noise():
    jf, params, pf = _disc_pair(seed=1)
    key = jax.random.PRNGKey(7)
    configs, lp = jf.apply(params, key, 128, method=jf.sample)
    k1, k2 = jax.random.split(key)
    modes = 2.0 * np.asarray(jax.random.bernoulli(
        k1, 0.5, (128, 8))).astype(np.float32) - 1.0
    eps = np.array(jax.random.normal(k2, (128, 8)))
    got, glp = pf.sample(128, noise=(torch.from_numpy(modes),
                                     torch.from_numpy(eps)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(configs))
    np.testing.assert_allclose(glp.detach().numpy(), np.asarray(lp),
                               **TOL)


@pytest.mark.parametrize("n_mc", [1, 16])
def test_discrete_flow_probability_matches_jax_given_eps(n_mc):
    jf, params, pf = _disc_pair(seed=2)
    rng = np.random.default_rng(5)
    configs = (rng.random((30, 8)) < 0.5).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jf.apply(params, key, jnp.asarray(configs), n_mc,
                               method=jf.estimate_discrete_prob))
    eps = _t(jax.random.normal(key, (n_mc, 30, 8)))
    got = pf.estimate_discrete_prob(torch.from_numpy(configs),
                                    eps=eps).detach().numpy()
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=PROB_RTOL, atol=TINY)


def test_discrete_flow_gradient_is_finite_outside_every_orthant():
    """A row whose proposals all miss its orthant has p = 0 and must give
    a zero gradient, not NaN (torch's and JAX's logsumexp give NaN)."""
    _, _, pf = _disc_pair(seed=3)
    configs = torch.zeros((3, 8))
    eps = torch.zeros((4, 3, 8))
    eps[:, 1] = 5.0                 # row 1: every proposal leaves the orthant
    p = pf.estimate_discrete_prob(configs, eps=eps)
    assert p[1] == 0 and (p[[0, 2]] > 0).all()
    torch.log(p + 1e-30).sum().backward()
    for prm in pf.parameters():
        assert torch.isfinite(prm.grad).all()
