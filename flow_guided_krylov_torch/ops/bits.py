"""Packed-bitstring utilities for Slater determinants.

Counterpart of ``flow_guided_krylov_tpu/ops/bits.py``, single-word only
(n_orb <= 32; the two-word forms are not ported yet).  A determinant is a
pair of words: alpha occupations in bit i of word 0, beta in word 1.

On the host the words are ``uint32`` NumPy arrays, bit-identical to the JAX
package's.  On the device they are ``int64`` tensors: torch's ``uint32``
lacks shifts, sort and ``searchsorted`` on CUDA, and a 32-bit word fits in
an int64 with room for the shifts below.  :func:`to_device` and
:func:`to_host` convert at the boundary.  Jordan-Wigner signs are parities
of masked words, folded in registers (torch has no popcount).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_np", "unpack_np", "keys_np", "parity_between_np",
    "to_device", "to_host", "occupancy", "unpack_device", "keys_device",
    "parity_between",
]

# The host key is (alpha << 32) | beta as uint64.  Its device twin is the
# same bits in an int64 with the top bit flipped, so that signed int64 order
# equals unsigned uint64 order (alpha may use bit 31 at n_orb = 32).
_SIGN_FLIP = -(1 << 63)


# ---------------------------------------------------------------------------
# Host (NumPy) side
# ---------------------------------------------------------------------------

def pack_np(configs: np.ndarray, n_orb: int) -> np.ndarray:
    """(B, 2*n_orb) 0/1 array -> (B, 2) uint32 [alpha_bits, beta_bits]."""
    configs = np.asarray(configs)
    w = (1 << np.arange(n_orb, dtype=np.uint64))
    a = (configs[:, :n_orb].astype(np.uint64) @ w).astype(np.uint32)
    b = (configs[:, n_orb:2 * n_orb].astype(np.uint64) @ w).astype(np.uint32)
    return np.stack([a, b], axis=-1)


def unpack_np(packed: np.ndarray, n_orb: int) -> np.ndarray:
    """(B, 2) uint32 -> (B, 2*n_orb) int8 occupation vectors."""
    packed = np.asarray(packed)
    shifts = np.arange(n_orb, dtype=np.uint32)
    a = (packed[:, 0:1] >> shifts) & 1
    b = (packed[:, 1:2] >> shifts) & 1
    return np.concatenate([a, b], axis=-1).astype(np.int8)


def keys_np(packed: np.ndarray) -> np.ndarray:
    """(B, 2) uint32 -> (B,) uint64 unique key (alpha << 32 | beta)."""
    packed = np.asarray(packed, dtype=np.uint64)
    return (packed[..., 0] << np.uint64(32)) | packed[..., 1]


# (1 << k) - 1 for k = 0..32, as uint32 (index 32 = all-ones)
_LOW_MASKS32 = ((np.uint64(1) << np.arange(33, dtype=np.uint64))
                - np.uint64(1)).astype(np.uint32)
# 1 << k for k = 0..31
_POW2_32 = (np.uint64(1) << np.arange(32, dtype=np.uint64)).astype(np.uint32)


def parity_between_np(bits: np.ndarray, p: np.ndarray, q: np.ndarray
                      ) -> np.ndarray:
    """(-1)^(# occupied orbitals strictly between p and q) as int32 sign.

    uint32 end to end with table-gathered masks: NumPy's uint64 and
    scalar<<array loops are far slower than a uint32 fancy-index take.
    The parity is an xor-fold, which needs no ``np.bitwise_count``
    (NumPy >= 2 only).
    """
    bits32 = np.asarray(bits).astype(np.uint32, copy=False)
    lo = np.minimum(p, q)
    hi = np.maximum(p, q)
    x = bits32 & (_LOW_MASKS32[hi] & ~_LOW_MASKS32[lo + 1])
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint32(s))
    return 1 - 2 * (x & np.uint32(1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Device (torch) side
# ---------------------------------------------------------------------------

def to_device(packed: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words -> device int64 words (same shape)."""
    return torch.as_tensor(np.asarray(packed, np.uint32).astype(np.int64),
                           device=device)


def to_host(words: torch.Tensor) -> np.ndarray:
    """Device int64 words -> host uint32 words (same shape)."""
    return words.cpu().numpy().astype(np.uint32)


def occupancy(bits: torch.Tensor, n_orb: int) -> torch.Tensor:
    """int64 words (...) -> (..., n_orb) int64 0/1 occupations."""
    shifts = torch.arange(n_orb, device=bits.device)
    return (bits.unsqueeze(-1) >> shifts) & 1


def unpack_device(packed: torch.Tensor, n_orb: int) -> torch.Tensor:
    """(..., 2) int64 words -> (..., 2*n_orb) float32 occupations."""
    return torch.cat([occupancy(packed[..., 0], n_orb),
                      occupancy(packed[..., 1], n_orb)], -1).float()


def keys_device(packed: torch.Tensor) -> torch.Tensor:
    """(..., 2) int64 words -> (...) int64 sort key, ordered like
    :func:`keys_np` (see ``_SIGN_FLIP``)."""
    return ((packed[..., 0] << 32) | packed[..., 1]) ^ _SIGN_FLIP


def _parity32(x: torch.Tensor) -> torch.Tensor:
    """Parity of the set bits of non-negative int64 values below 2**32
    (SWAR xor-fold: each step folds the upper half onto the lower)."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def parity_between(bits: torch.Tensor, p: torch.Tensor, q: torch.Tensor
                   ) -> torch.Tensor:
    """(-1)^(# occupied orbitals strictly between p and q) as int64 sign.

    The Jordan-Wigner sign of a+_q a_p on ``bits`` (p occupied, q empty);
    ``bits`` broadcasts against the int64 orbital tensors ``p`` and ``q``.
    """
    lo = torch.minimum(p, q)
    hi = torch.maximum(p, q)
    mask = ((1 << hi) - 1) & ~((1 << (lo + 1)) - 1)
    return 1 - 2 * _parity32(bits & mask)
