"""Dense (MLP) neural quantum states.

Counterparts of ``flow_guided_krylov_tpu/models/dense.py``:

* :class:`DenseNQS` — an MLP (``relu``, ``tanh``, ``gelu`` or ``silu``),
  then ``Linear(., 1)``, then ``log_amp_scale * tanh``; the model the
  pipeline trains.  ``compute_dtype=torch.bfloat16`` runs the hidden
  layers in bfloat16 and the output layer in float32, as flax
  ``Dense(dtype=...)`` does.
* :class:`SignedDenseNQS` — the same network with a sign read from the
  output layer (phase in {0, pi}).

Parameters start as flax initializes them (LeCun-normal kernels, zero
biases, ``log_amp_scale = 1``), because the training dynamics depend on the
starting point.

A fault of the reference, kept: flax gives the ``Dense_i`` of two
``@nn.compact`` methods of one module the same parameters, so the JAX
package's "phase net" of ``DenseNQS(complex_output=True)`` and "sign
head" of ``SignedDenseNQS`` are the amplitude network itself: both read
the output layer before its ``tanh``.  The port computes that, not the
separate heads the JAX docstrings describe (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .base import NeuralQuantumState

__all__ = ["DenseNQS", "SignedDenseNQS", "lecun_normal_"]

# std of a unit normal truncated to [-2, 2]; flax divides by it so the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978

# flax's nn.gelu is the tanh approximation by default
ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "gelu": partial(F.gelu, approximate="tanh"), "silu": F.silu}


def lecun_normal_(linear: nn.Linear,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's default Dense init: kernel ~ truncated normal on [-2s, 2s]
    with s = sqrt(1/fan_in)/0.8796..., bias 0."""
    std = math.sqrt(1.0 / linear.in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        linear.bias.zero_()


def mlp_layers(widths: Sequence[int]) -> nn.ModuleList:
    """``Linear(widths[i], widths[i + 1])`` for each consecutive pair."""
    return nn.ModuleList(nn.Linear(a, b)
                         for a, b in zip(widths[:-1], widths[1:]))


class DenseNQS(NeuralQuantumState):
    """(B, num_sites) 0/1 floats -> (B,) float32 log|psi|.

    ``dense[i]`` is flax's ``Dense_i`` (the last one is the output layer),
    so :func:`~flow_guided_krylov_torch.convert.dense_nqs_state_dict` maps
    weights one to one.  With ``complex_output`` the phase is the output
    layer's value before ``tanh`` (module docstring); without, zeros."""

    def __init__(self, num_sites: int,
                 hidden_dims: Sequence[int] = (512, 512, 512, 512),
                 activation: str = "relu", complex_output: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; "
                             f"available: {sorted(ACTIVATIONS)}")
        self.num_sites = num_sites
        self.hidden_dims = tuple(hidden_dims)
        self.activation = activation
        self.complex_output = complex_output
        self.compute_dtype = compute_dtype
        self.dense = mlp_layers((num_sites,) + self.hidden_dims + (1,))
        self.log_amp_scale = nn.Parameter(torch.ones(()))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for layer in self.dense:
            lecun_normal_(layer, generator)
        with torch.no_grad():
            self.log_amp_scale.fill_(1.0)

    def output_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B,) float32 output layer before its ``tanh``: the hidden layers
        in ``compute_dtype``, the output layer in float32."""
        act = ACTIVATIONS[self.activation]
        cd = self.compute_dtype
        h = x.to(cd)
        for layer in self.dense[:-1]:
            h = act(F.linear(h, layer.weight.to(cd), layer.bias.to(cd)))
        return self.dense[-1](h.float()).squeeze(-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_amp_scale * torch.tanh(self.output_logits(x))

    def phase(self, x: torch.Tensor) -> torch.Tensor:
        if self.complex_output:
            return self.output_logits(x)
        return super().phase(x)


class SignedDenseNQS(DenseNQS):
    """Amplitude and sign from one network: the sign of the output layer
    before its ``tanh`` gives phase 0 (>= 0) or pi (< 0) — the JAX
    package's computation (module docstring)."""

    def __init__(self, num_sites: int, hidden_dims: Sequence[int] = (256, 256),
                 activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_sites, hidden_dims, activation,
                         generator=generator)

    def sign_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_logits(x)

    def phase(self, x: torch.Tensor) -> torch.Tensor:
        return math.pi * (self.sign_logits(x) < 0).float()
