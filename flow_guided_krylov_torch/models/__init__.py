"""Wavefunction models (neural quantum states)."""

from .base import (NeuralQuantumState, normalized_probability, probability,
                   psi)
from .complex_nqs import ComplexNQS, RBMQuantumState
from .dense import DenseNQS, SignedDenseNQS

__all__ = [
    "NeuralQuantumState", "psi", "probability", "normalized_probability",
    "DenseNQS", "SignedDenseNQS", "ComplexNQS", "RBMQuantumState",
]
