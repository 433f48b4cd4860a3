"""Complex-valued neural quantum states.

Counterparts of ``flow_guided_krylov_tpu/models/complex_nqs.py``:

* :class:`ComplexNQS` — a GELU trunk (flax's tanh approximation) with an
  amplitude head and an unbounded phase head;
* :class:`RBMQuantumState` — the restricted Boltzmann machine
  log psi = sum_j a_j s_j + sum_i log cosh(b_i + W_i . s) on spins
  s = 2x - 1, with real or complex weights.

Parameter names follow flax's (``dense[i]`` is ``Dense_i``; the RBM's
``a``, ``w``, ``b`` or their ``_real`` / ``_imag`` pairs), so
``convert`` maps them one to one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .base import NeuralQuantumState
from .dense import lecun_normal_, mlp_layers

__all__ = ["ComplexNQS", "RBMQuantumState"]


class ComplexNQS(NeuralQuantumState):
    """``dense[:k]`` the trunk, ``dense[k]`` the log-amplitude head and
    ``dense[k + 1]`` the phase head, k = len(hidden_dims)."""

    def __init__(self, num_sites: int, hidden_dims: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_sites = num_sites
        self.hidden_dims = tuple(hidden_dims)
        widths = (num_sites,) + self.hidden_dims
        self.dense = mlp_layers(widths)
        self.dense.append(nn.Linear(widths[-1], 1))
        self.dense.append(nn.Linear(widths[-1], 1))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for layer in self.dense:
            lecun_normal_(layer, generator)

    def amplitude_and_phase(self, x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for layer in self.dense[:-2]:
            h = F.gelu(layer(h), approximate="tanh")
        return (self.dense[-2](h).squeeze(-1),
                self.dense[-1](h).squeeze(-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.amplitude_and_phase(x)[0]

    def phase(self, x: torch.Tensor) -> torch.Tensor:
        return self.amplitude_and_phase(x)[1]


class RBMQuantumState(NeuralQuantumState):
    """RBM wavefunction over ``n_hidden`` hidden units; parameters start
    as flax's ``normal(0.01)``."""

    def __init__(self, num_sites: int, n_hidden: int = 64,
                 complex_weights: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_sites = num_sites
        self.n_hidden = n_hidden
        self.complex_weights = complex_weights
        shapes = {"a": (num_sites,), "w": (n_hidden, num_sites),
                  "b": (n_hidden,)}
        parts = ("_real", "_imag") if complex_weights else ("",)
        for name, shape in shapes.items():
            for part in parts:
                self.register_parameter(name + part,
                                        nn.Parameter(torch.zeros(shape)))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        with torch.no_grad():
            for p in self.parameters():
                p.normal_(0.0, 0.01, generator=generator)

    def _log_psi_parts(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        s = 2.0 * x - 1.0
        if self.complex_weights:
            a = torch.complex(self.a_real, self.a_imag)
            w = torch.complex(self.w_real, self.w_imag)
            b = torch.complex(self.b_real, self.b_imag)
            sc = s.to(torch.complex64)
            z = sc @ w.T + b
            log_psi = sc @ a + torch.log(torch.cosh(z)).sum(-1)
            return log_psi.real, log_psi.imag
        z = s @ self.w.T + self.b
        az = z.abs()
        log_psi = s @ self.a + (az + torch.log1p(torch.exp(-2.0 * az))
                                - math.log(2.0)).sum(-1)
        return log_psi, torch.zeros_like(log_psi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._log_psi_parts(x)[0]

    def phase(self, x: torch.Tensor) -> torch.Tensor:
        return self._log_psi_parts(x)[1]
