"""Particle-conserving normalizing flow (Gumbel top-k).

Counterpart of ``flow_guided_krylov_tpu/flows/particle_conserving.py``:
samples determinants with exactly n_alpha alpha and n_beta beta electrons
by Gumbel-top-k selection over per-orbital logits: alpha from a learnable
prior, beta from an MLP conditioned on the sampled alpha occupation.

Randomness comes from an explicit ``torch.Generator``, or from uniforms
the caller passes in (the parity tests feed the JAX package's).  The
layer names and the JAX module's quirks are kept, since training depends
on them and weights map one to one: ``beta_h0`` reads
``concat(zeros(n_orb), context)``, and ``beta_h1`` has width
``hidden_dims[-1]``.

:class:`SzConservingFlow` is the spin analog of the alpha channel: k-hot
configurations of n sites from learnable site logits, for spin
Hamiltonians that conserve total S_z.  :class:`OrbitalScoringNetwork`
is the standalone per-orbital scorer and :class:`GumbelTopK` an object
holding a temperature over :func:`gumbel_topk`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.dense import lecun_normal_, mlp_layers

__all__ = ["ParticleConservingFlow", "ParticleConservingFlowSampler",
           "SzConservingFlow", "gumbel_topk", "GumbelTopK",
           "OrbitalScoringNetwork", "verify_particle_conservation"]


def _gumbel_uniforms(shape, generator: Optional[torch.Generator],
                     device) -> torch.Tensor:
    """Uniforms in [1e-10, 1), as the JAX package draws them."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u * (1.0 - 1e-10) + 1e-10).clamp_min_(1e-10)


def gumbel_topk(logits: torch.Tensor, k: int, temperature,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[torch.Tensor] = None,
                hard: bool = True) -> torch.Tensor:
    """Differentiable k-hot sample: (B, n) logits -> (B, n) mask with k ones.

    Straight-through: the hard k-hot mask forward, the softmax's gradient
    backward.  ``hard=False`` returns the tempered softmax of the perturbed
    logits instead.  ``uniforms`` (B, n) replaces the draw from
    ``generator``.
    """
    u = (uniforms if uniforms is not None
         else _gumbel_uniforms(logits.shape, generator, logits.device))
    z = (logits - torch.log(-torch.log(u))) / temperature
    if not hard:
        return torch.softmax(z, -1)
    idx = torch.topk(z, k, dim=-1).indices
    one_hot = torch.zeros_like(logits).scatter_(-1, idx, 1.0)
    soft = torch.softmax(z, -1) * one_hot
    return one_hot - soft.detach() + soft


def _topk_log_prob(logits: torch.Tensor, selection: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Approximate log-probability of an (unordered) top-k selection."""
    logp = torch.log_softmax(logits, -1)
    return (logp * selection).sum(-1) - math.lgamma(k + 1.0)


class ParticleConservingFlow(nn.Module):
    """Exact-particle-number determinant sampler."""

    def __init__(self, n_orbitals: int, n_alpha: int, n_beta: int,
                 hidden_dims: Sequence[int] = (256, 256),
                 context_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_orbitals = n_orbitals
        self.n_alpha = n_alpha
        self.n_beta = n_beta
        self.hidden_dims = tuple(hidden_dims)
        self.context_dim = context_dim
        n = n_orbitals
        self.alpha_prior_logits = nn.Parameter(torch.zeros(n))
        self.a2b_in = nn.Linear(n, 128)
        self.a2b_out = nn.Linear(128, context_dim)
        self.beta_h0 = nn.Linear(n + context_dim, self.hidden_dims[0])
        self.beta_h1 = nn.Linear(self.hidden_dims[0], self.hidden_dims[-1])
        self.beta_out = nn.Linear(self.hidden_dims[-1], n)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for layer in (self.a2b_in, self.a2b_out, self.beta_h0, self.beta_h1,
                      self.beta_out):
            lecun_normal_(layer, generator)
        with torch.no_grad():
            self.alpha_prior_logits.zero_()

    def _alpha_logits(self, batch_size: int) -> torch.Tensor:
        return self.alpha_prior_logits[None, :].expand(batch_size, -1)

    def _beta_logits(self, alpha_config: torch.Tensor) -> torch.Tensor:
        silu = nn.functional.silu
        ctx = self.a2b_out(silu(self.a2b_in(alpha_config)))
        h = torch.cat([torch.zeros_like(alpha_config), ctx], -1)
        h = silu(self.beta_h0(h))
        h = silu(self.beta_h1(h))
        return self.beta_out(h)

    def sample(self, batch_size: int, temperature,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 2*n_orbitals) configurations and (B,) log-probs.
        ``uniforms`` = (alpha (B, n), beta (B, n)) replaces the draws."""
        u_a, u_b = uniforms if uniforms is not None else (None, None)
        alpha_logits = self._alpha_logits(batch_size)
        alpha = gumbel_topk(alpha_logits, self.n_alpha, temperature,
                            generator, u_a)
        alpha_hard = torch.round(alpha).detach()
        beta_logits = self._beta_logits(alpha_hard)
        beta = gumbel_topk(beta_logits, self.n_beta, temperature,
                           generator, u_b)
        configs = torch.cat([alpha, beta], -1)
        log_probs = (_topk_log_prob(alpha_logits, alpha_hard, self.n_alpha)
                     + _topk_log_prob(beta_logits, torch.round(beta).detach(),
                                      self.n_beta))
        return configs, log_probs

    def log_prob(self, configs: torch.Tensor) -> torch.Tensor:
        """Log-probability of given (B, 2n) configurations."""
        n = self.n_orbitals
        alpha, beta = configs[:, :n], configs[:, n:]
        return (_topk_log_prob(self._alpha_logits(configs.shape[0]), alpha,
                               self.n_alpha)
                + _topk_log_prob(self._beta_logits(alpha), beta, self.n_beta))

    def estimate_discrete_prob(self, configs: torch.Tensor) -> torch.Tensor:
        """p(x) = exp(log p(x))."""
        return torch.exp(self.log_prob(configs))


class SzConservingFlow(nn.Module):
    """Exact-magnetization spin sampler: Gumbel top-k over site logits.

    For a Hamiltonian that conserves total S_z the ground state lies in
    one fixed-popcount sector, so every sample has exactly ``n_up`` up
    spins.  The flax parameter is ``site_logits`` (n,), zeros at start.
    The methods take the arguments of :class:`~.discrete.
    DiscreteFlowSampler`'s, so one :class:`~.spin_training.
    SpinFlowTrainer` drives either; the top-k probability is exact, so
    ``estimate_discrete_prob`` ignores its Monte Carlo arguments."""

    def __init__(self, n_sites: int, n_up: int):
        super().__init__()
        self.n_sites = n_sites
        self.n_up = n_up
        self.site_logits = nn.Parameter(torch.zeros(n_sites))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        with torch.no_grad():
            self.site_logits.zero_()

    def _logits(self, batch_size: int) -> torch.Tensor:
        return self.site_logits[None, :].expand(batch_size, -1)

    def sample(self, batch: int, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, n) k-hot configurations and (B,) log-probs; ``noise`` (B, n)
        uniforms in [1e-10, 1) replaces the draw from ``generator``."""
        logits = self._logits(batch)
        occ = gumbel_topk(logits, self.n_up, 1.0, generator, noise)
        return occ, _topk_log_prob(logits, torch.round(occ).detach(),
                                   self.n_up)

    def log_prob(self, configs: torch.Tensor) -> torch.Tensor:
        return _topk_log_prob(self._logits(configs.shape[0]), configs,
                              self.n_up)

    def estimate_discrete_prob(self, configs: torch.Tensor, n_mc: int = 0,
                               generator: Optional[torch.Generator] = None,
                               eps: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        return torch.exp(self.log_prob(configs))


# the JAX package's name for the flow as a sampler (an alias there too)
ParticleConservingFlowSampler = ParticleConservingFlow


class OrbitalScoringNetwork(nn.Module):
    """Standalone per-orbital scorer: (B, n_orbitals) occupations ->
    (B, n_orbitals) logits, occupied orbitals at -inf; with no context,
    the learnable prior broadcast to ``batch_size`` rows.

    ``dense[i]`` is flax's ``Dense_i``: ``Dense(hidden[0])``,
    ``Dense(context_dim)``, one ``Dense(d)`` a hidden width, then
    ``Dense(n_orbitals)``; SiLU after each but the second and the last."""

    def __init__(self, n_orbitals: int,
                 hidden_dims: Sequence[int] = (256, 256),
                 context_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_orbitals = n_orbitals
        self.hidden_dims = tuple(hidden_dims)
        self.context_dim = context_dim
        self.dense = mlp_layers((n_orbitals, self.hidden_dims[0], context_dim)
                                + self.hidden_dims + (n_orbitals,))
        self.prior_logits = nn.Parameter(torch.zeros(n_orbitals))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for layer in self.dense:
            lecun_normal_(layer, generator)
        with torch.no_grad():
            self.prior_logits.zero_()

    def forward(self, context: Optional[torch.Tensor] = None,
                batch_size: int = 1) -> torch.Tensor:
        if context is None:
            return self.prior_logits[None, :].expand(batch_size, -1)
        silu = nn.functional.silu
        h = self.dense[1](silu(self.dense[0](context)))
        for layer in self.dense[2:-1]:
            h = silu(layer(h))
        logits = self.dense[-1](h)
        return torch.where(context > 0.5,
                           torch.full_like(logits, -torch.inf), logits)


class GumbelTopK:
    """:func:`gumbel_topk` at a fixed temperature."""

    def __init__(self, temperature: float = 1.0):
        self.temperature = temperature

    def __call__(self, logits: torch.Tensor, k: int, hard: bool = True,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        return gumbel_topk(logits, k, float(np.float32(self.temperature)),
                           generator, uniforms, hard)


def verify_particle_conservation(configs, n_alpha: int, n_beta: int,
                                 n_orbitals: int) -> dict:
    """Audit sampled configs: every row must hold n_alpha alpha and
    n_beta beta electrons."""
    configs = np.asarray(configs)
    a = configs[:, :n_orbitals].sum(axis=-1)
    b = configs[:, n_orbitals:2 * n_orbitals].sum(axis=-1)
    ok = (a == n_alpha) & (b == n_beta)
    return {
        "all_valid": bool(ok.all()),
        "fraction_valid": float(ok.mean()) if len(ok) else 1.0,
        "n_violations": int((~ok).sum()),
        "alpha_counts": (int(a.min()), int(a.max())) if len(a) else (0, 0),
        "beta_counts": (int(b.min()), int(b.max())) if len(b) else (0, 0),
    }
