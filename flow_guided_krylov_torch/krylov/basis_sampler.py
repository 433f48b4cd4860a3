"""The circuit-based sampler: the classical stand-in for a quantum circuit.

Counterpart of ``flow_guided_krylov_tpu/krylov/basis_sampler.py``.
:class:`KrylovBasisSampler` Trotter-evolves a product state by Pauli-word
rotations exp(-i theta P) on a 2^n (re, im) float32 statevector and
samples it.  The rotation and the Pauli-word parser live beside the
x_sweep kernel in ``ops/x_sweep.py``, whose plain version they are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..hamiltonians.spin import extract_coeffs_and_paulis
from ..ops.x_sweep import _pauli_masks, _pauli_rotation_pair
from .skqd import _sample_idx_cdf

__all__ = ["CircuitSamplerConfig", "KrylovBasisSampler",
           "create_circuit_sampler"]


@dataclass
class CircuitSamplerConfig:
    """Sampler knobs (the JAX package's names and defaults)."""
    shots: int = 10_000
    num_trotter_steps: int = 4
    time_step: float = 0.1
    initial_state: str = "neel"      # 'neel' | 'zeros' | 'ones'
    seed: int = 0


class KrylovBasisSampler:
    """Trotter-evolve an initial product state, measure, propose configs.

    The statevector lives on ``device``; measurements draw from a
    ``torch.Generator`` seeded with ``config.seed``."""

    def __init__(self, coefficients: Sequence[float],
                 pauli_words: Sequence[str], n_qubits: int,
                 config: Optional[CircuitSamplerConfig] = None, *, device):
        self.coeffs = [float(c) for c in coefficients]
        self.words = list(pauli_words)
        if any(len(w) != n_qubits for w in self.words):
            raise ValueError("Pauli word length != n_qubits")
        self.n_qubits = n_qubits
        self.config = config or CircuitSamplerConfig()
        self.masks = [_pauli_masks(w) for w in self.words]
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)

    def _initial_state(self) -> int:
        kind = self.config.initial_state
        if kind == "zeros":
            return 0
        if kind == "ones":
            return (1 << self.n_qubits) - 1
        if kind == "neel":
            return sum(1 << i for i in range(0, self.n_qubits, 2))
        raise ValueError(f"unknown initial state {kind!r}")

    def _evolve(self, t: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """First-order Trotterized exp(-i H t)|psi0> on the device."""
        c = self.config
        re = torch.zeros(1 << self.n_qubits, dtype=torch.float32,
                         device=self.device)
        re[self._initial_state()] = 1.0
        im = torch.zeros_like(re)
        dt = t / c.num_trotter_steps
        for _ in range(c.num_trotter_steps):
            for coef, (xm, zm, ny) in zip(self.coeffs, self.masks):
                re, im = _pauli_rotation_pair(re, im, coef * dt, xm, zm, ny,
                                              self.n_qubits)
        return re, im

    def evolve_statevector(self, t: float) -> np.ndarray:
        """The evolved state as a host complex vector."""
        re, im = self._evolve(t)
        return re.cpu().numpy() + 1j * im.cpu().numpy()

    def sample(self, t: Optional[float] = None,
               shots: Optional[int] = None) -> Dict[int, int]:
        """Measurement counts {configuration: count} after evolving for t,
        drawn by inverse CDF on the device."""
        c = self.config
        t = c.time_step if t is None else t
        shots = c.shots if shots is None else shots
        re, im = self._evolve(t)
        u = torch.rand(shots, generator=self.generator, device=self.device)
        idx = _sample_idx_cdf(re ** 2 + im ** 2, u)
        vals, counts = torch.unique(idx, return_counts=True)
        return dict(zip(vals.tolist(), counts.tolist()))

    def sample_krylov_bases(self, max_krylov_dim: int
                            ) -> List[Dict[int, int]]:
        """Counts at t = k * dt for k = 0..K-1 (one circuit depth per k)."""
        return [self.sample(t=k * self.config.time_step)
                for k in range(max_krylov_dim)]


def create_circuit_sampler(hamiltonian,
                           config: Optional[CircuitSamplerConfig] = None
                           ) -> KrylovBasisSampler:
    """A sampler for a spin Hamiltonian, on the Hamiltonian's device."""
    coeffs, words = extract_coeffs_and_paulis(hamiltonian)
    return KrylovBasisSampler(coeffs, words, hamiltonian.n_sites, config,
                              device=hamiltonian.device)
