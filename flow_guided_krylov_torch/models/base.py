"""Neural quantum state base class and derived wavefunction quantities.

Counterpart of ``flow_guided_krylov_tpu/models/base.py``: a model maps
(B, num_sites) occupations to (B,) ``log|psi|`` and, where it has one, a
``phase``; these functions turn log-amplitudes into amplitudes and
probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["NeuralQuantumState", "psi", "probability",
           "normalized_probability"]


class NeuralQuantumState(nn.Module):
    """Base class: ``forward(x)`` gives (B,) log|psi|; ``phase(x)``
    defaults to zeros (a real, positive wavefunction)."""

    def phase(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)


def psi(log_amp: torch.Tensor, phase: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """Amplitude from log|psi|, complex when a phase is given."""
    amp = torch.exp(log_amp)
    if phase is None:
        return amp
    return amp * torch.exp(1j * phase)


def probability(log_amp: torch.Tensor) -> torch.Tensor:
    """|psi|^2 = exp(2 log|psi|)."""
    return torch.exp(2.0 * log_amp)


def normalized_probability(log_amp: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Batch-normalized |psi|^2 with a logsumexp partition; rows where
    ``mask`` is false get probability 0."""
    logp = 2.0 * log_amp
    if mask is not None:
        logp = torch.where(mask, logp, torch.full_like(logp, -torch.inf))
    return torch.exp(logp - torch.logsumexp(logp, 0))
