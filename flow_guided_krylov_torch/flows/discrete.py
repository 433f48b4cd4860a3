"""Discrete flow sampler: RealNVP over a bimodal prior, sign-discretized.

Counterpart of ``flow_guided_krylov_tpu/flows/discrete.py``: a masked
affine (RealNVP) normalizing flow over R^n with a two-mode (+/-1 Gaussian
mixture) prior.  Configurations are the signs of its samples (site i up
where y_i > 0), and the discrete probability p(x), the integral of the
continuous density over the orthant of x, is estimated by importance
sampling with a logsumexp accumulator.

It samples the spin systems that do not conserve S_z (the pipeline picks
:class:`~.particle_conserving.SzConservingFlow` for those that do).
Randomness comes from an explicit ``torch.Generator``, or from noise the
caller passes in (the parity tests feed the JAX package's).  Layer order
and shapes are flax's, so weights map one to one
(``convert.discrete_flow_state_dict``): coupling i's ``dense[0..3]`` are
its ``Dense_0..3`` (two hidden layers, log-scale, shift).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..models.dense import lecun_normal_

__all__ = ["DiscreteFlowSampler", "MultiModalPrior"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(x))) along ``dim``, shifted by the detached maximum as
    ``jax.nn.logsumexp`` is.  A slice of only -inf gives -inf with a zero
    gradient (``torch.logsumexp`` and JAX's give NaN there), so an orthant
    that no proposal sample hit cannot turn the flow's gradient into NaN."""
    m = x.detach().amax(dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(x - m).sum(dim)
    hit = s > 0
    out = torch.log(torch.where(hit, s, torch.ones_like(s))) + m.squeeze(dim)
    return torch.where(hit, out, torch.full_like(out, -torch.inf))


class MultiModalPrior:
    """Per-dimension mixture 0.5 N(+1, s^2) + 0.5 N(-1, s^2)."""

    def __init__(self, n_dims: int, sigma: float = 0.5):
        self.n_dims = n_dims
        self.sigma = sigma

    def sample(self, batch: int, generator: Optional[torch.Generator] = None,
               noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               device=None) -> torch.Tensor:
        """(B, n) draws.  ``noise`` = (modes (B, n) of +/-1, eps (B, n)
        standard normals) replaces the draw from ``generator``."""
        if noise is None:
            shape = (batch, self.n_dims)
            bern = torch.rand(shape, generator=generator, device=device) < 0.5
            noise = (2.0 * bern.to(torch.float32) - 1.0,
                     torch.randn(shape, generator=generator, device=device))
        modes, eps = noise
        return modes + self.sigma * eps

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        s = self.sigma

        def comp(mu):
            return -0.5 * ((z - mu) / s) ** 2 - math.log(s) - _HALF_LOG_2PI
        lp = torch.logaddexp(comp(1.0), comp(-1.0)) - math.log(2.0)
        return lp.sum(-1)


class _Coupling(nn.Module):
    """Masked affine coupling: the sites where ``mask`` is 1 pass through
    and condition a log-scale (tanh, clamped to +/-2) and a shift of the
    others."""

    def __init__(self, n_dims: int, hidden: int, mask: torch.Tensor):
        super().__init__()
        self.register_buffer("mask", mask.to(torch.float32), persistent=False)
        self.dense = nn.ModuleList([
            nn.Linear(n_dims, hidden), nn.Linear(hidden, hidden),
            nn.Linear(hidden, n_dims), nn.Linear(hidden, n_dims)])

    def _nets(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.relu(self.dense[0](x * self.mask))
        h = torch.relu(self.dense[1](h))
        s = torch.tanh(self.dense[2](h)) * 2.0
        t = self.dense[3](h)
        free = 1 - self.mask
        return s * free, t * free

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        s, t = self._nets(z)
        return z * torch.exp(s) + t, s.sum(-1)

    def inverse(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        s, t = self._nets(y)
        return (y - t) * torch.exp(-s), -s.sum(-1)


class DiscreteFlowSampler(nn.Module):
    """RealNVP + bimodal prior + sign discretization; the couplings
    alternate the parity of the sites they pass through."""

    def __init__(self, n_sites: int, n_layers: int = 6, hidden: int = 128,
                 prior_sigma: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_sites = n_sites
        self.n_layers = n_layers
        self.hidden = hidden
        self.prior_sigma = prior_sigma
        parity = torch.arange(n_sites) % 2
        self.couplings = nn.ModuleList(
            _Coupling(n_sites, hidden, parity if i % 2 == 0 else 1 - parity)
            for i in range(n_layers))
        self.prior = MultiModalPrior(n_sites, prior_sigma)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for c in self.couplings:
            for layer in c.dense:
                lecun_normal_(layer, generator)

    # ------------------------------------------------------------------

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logdet = torch.zeros(z.shape[0], device=z.device)
        y = z
        for c in self.couplings:
            y, ld = c(y)
            logdet = logdet + ld
        return y, logdet

    def inverse(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logdet = torch.zeros(y.shape[0], device=y.device)
        z = y
        for c in reversed(self.couplings):
            z, ld = c.inverse(z)
            logdet = logdet + ld
        return z, logdet

    def continuous_log_prob(self, y: torch.Tensor) -> torch.Tensor:
        z, logdet = self.inverse(y)
        return self.prior.log_prob(z) + logdet

    # ------------------------------------------------------------------

    def sample(self, batch: int, generator: Optional[torch.Generator] = None,
               noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, n) configurations in {0, 1} and their continuous log-probs;
        ``noise`` is the prior's (modes, eps)."""
        z = self.prior.sample(batch, generator, noise,
                              device=self.couplings[0].mask.device)
        y, logdet = self.forward(z)
        configs = (y > 0).to(torch.float32)
        return configs, self.prior.log_prob(z) - logdet

    def estimate_discrete_prob(self, configs: torch.Tensor, n_mc: int = 64,
                               generator: Optional[torch.Generator] = None,
                               eps: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """Importance-sampled p(x) = integral of p_Y over the orthant of x.

        Proposal y = sign(x) + sigma * eps, eps (n_mc, B, n) standard
        normals (from ``generator``, or ``eps``); a sample outside the
        orthant weighs 0, and p_Y / q averages in log space.  The flow sees
        all n_mc * B proposals as one batch."""
        signs = 2.0 * configs - 1.0                         # (B, n)
        B, n = configs.shape
        sigma = self.prior_sigma
        if eps is None:
            eps = torch.randn((n_mc, B, n), generator=generator,
                              device=configs.device)
        n_mc = eps.shape[0]
        y = signs[None] + sigma * eps
        inside = torch.all(y * signs[None] > 0, dim=-1)     # (n_mc, B)
        log_q = (-0.5 * eps ** 2 - math.log(sigma) - _HALF_LOG_2PI).sum(-1)
        log_p = self.continuous_log_prob(y.reshape(n_mc * B, n)
                                         ).reshape(n_mc, B)
        log_w = torch.where(inside, log_p - log_q,
                            torch.full_like(log_p, -torch.inf))
        return torch.exp(_logsumexp(log_w, 0) - math.log(n_mc))

    def log_prob(self, configs: torch.Tensor, n_mc: int = 64,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.log(self.estimate_discrete_prob(
            configs, n_mc, generator, eps) + 1e-30)
