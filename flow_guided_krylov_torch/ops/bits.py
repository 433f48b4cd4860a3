"""Packed-bitstring utilities for Slater determinants.

Counterpart of ``flow_guided_krylov_tpu/ops/bits.py``.  Up to 32
orbitals a determinant is a pair of words: alpha occupations in bit i of
word 0, beta in word 1.  From 33 to 64 orbitals each spin channel spans
two words in [hi, lo] order (orbital i < 32 in lo, i >= 32 in hi), so
lexicographic word order equals numeric order, and a determinant is the
row [a_hi, a_lo, b_hi, b_lo] (the ``*2`` primitives below).

On the host the words are ``uint32`` NumPy arrays, bit-identical to the JAX
package's.  On the device they are ``int64`` tensors: torch's ``uint32``
lacks shifts, sort and ``searchsorted`` on CUDA, and a 32-bit word fits in
an int64 with room for the shifts below.  :func:`to_device` and
:func:`to_host` convert at the boundary.  Jordan-Wigner signs are parities
of masked words, folded in registers (torch has no popcount).  On the
device a two-word channel becomes one 64-bit quantity
(``(hi << 32) | lo`` in an int64, :func:`join2`), so its parity is one
masked fold where the TPU took two uint32 windows; the results are
bit-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_np", "unpack_np", "keys_np", "from_keys_np", "parity_between_np",
    "to_device", "to_host", "occupancy", "pack_device", "unpack_device",
    "keys_device",
    "unkey_device", "parity_between",
    "pack2_np", "occupancy2_np", "flip_orbital2_np", "parity_between2_np",
    "join2", "split2", "occupancy2", "flip_orbital2", "parity_between2",
    "parity_between64",
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


def from_keys_np(keys: np.ndarray) -> np.ndarray:
    """(B,) uint64 keys -> (B, 2) uint32 [alpha, beta] (inverse of
    :func:`keys_np`)."""
    keys = np.asarray(keys, dtype=np.uint64)
    a = (keys >> np.uint64(32)).astype(np.uint32)
    b = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([a, b], axis=-1)


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


def pack_device(occ: torch.Tensor) -> torch.Tensor:
    """(..., n_orb) 0/1 -> (...) int64 word (inverse of :func:`occupancy`,
    n_orb <= 32)."""
    shifts = torch.arange(occ.shape[-1], device=occ.device)
    return (occ.to(torch.int64) << shifts).sum(-1)


def unpack_device(packed: torch.Tensor, n_orb: int) -> torch.Tensor:
    """(..., 2) int64 words, or (..., 4) [hi, lo] words a channel past 32
    orbitals -> (..., 2*n_orb) float32 occupations."""
    if packed.shape[-1] == 4:
        return torch.cat([occupancy2(packed[..., 0:2], n_orb),
                          occupancy2(packed[..., 2:4], n_orb)], -1).float()
    return torch.cat([occupancy(packed[..., 0], n_orb),
                      occupancy(packed[..., 1], n_orb)], -1).float()


def keys_device(packed: torch.Tensor) -> torch.Tensor:
    """(..., 2) int64 words -> (...) int64 sort key, ordered like
    :func:`keys_np` (see ``_SIGN_FLIP``)."""
    return ((packed[..., 0] << 32) | packed[..., 1]) ^ _SIGN_FLIP


def unkey_device(keys: torch.Tensor) -> torch.Tensor:
    """(...) int64 keys -> (..., 2) int64 words (inverse of
    :func:`keys_device`)."""
    u = keys ^ _SIGN_FLIP
    return torch.stack([(u >> 32) & 0xFFFFFFFF, u & 0xFFFFFFFF], -1)


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


# ---------------------------------------------------------------------------
# Two-word (33..64 orbital) channels: host mirrors, uint32 end to end
# ---------------------------------------------------------------------------

def pack2_np(occ: np.ndarray) -> np.ndarray:
    """(..., n_orb) 0/1 -> (..., 2) uint32 [hi, lo] channel words."""
    occ = np.asarray(occ)
    n = occ.shape[-1]
    lo = (occ[..., :32].astype(np.uint64)
          @ (np.uint64(1) << np.arange(min(n, 32), dtype=np.uint64))
          ).astype(np.uint32)
    hi = (occ[..., 32:].astype(np.uint64)
          @ (np.uint64(1) << np.arange(max(n - 32, 0), dtype=np.uint64))
          ).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def occupancy2_np(bits2: np.ndarray, n_orb: int) -> np.ndarray:
    """(..., 2) uint32 [hi, lo] -> (..., n_orb) int8 occupations."""
    shifts_lo = np.arange(32, dtype=np.uint32)
    shifts_hi = np.arange(n_orb - 32, dtype=np.uint32)
    lo = (bits2[..., 1:2] >> shifts_lo) & np.uint32(1)
    hi = (bits2[..., 0:1] >> shifts_hi) & np.uint32(1)
    return np.concatenate([lo, hi], axis=-1).astype(np.int8)


def flip_orbital2_np(bits2: np.ndarray, p: np.ndarray) -> np.ndarray:
    """XOR orbital bit ``p`` of a two-word channel; ``bits2`` (..., 2)
    broadcasts against ``p`` (...)."""
    w = p >> 5
    m = _POW2_32[p & 31]
    z = np.uint32(0)
    hi = bits2[..., 0] ^ np.where(w == 1, m, z)
    lo = bits2[..., 1] ^ np.where(w == 0, m, z)
    return np.stack([hi, lo], axis=-1)


def parity_between2_np(bits2: np.ndarray, p: np.ndarray, q: np.ndarray
                       ) -> np.ndarray:
    """Two-word :func:`parity_between_np`: (-1)^(# occupied orbitals
    strictly between p and q) across both words, as int32."""
    p = np.asarray(p, np.int32)
    q = np.asarray(q, np.int32)
    s = np.minimum(p, q) + 1
    e = np.maximum(p, q)
    m_lo = (_LOW_MASKS32[np.clip(e, 0, 32)]
            & ~_LOW_MASKS32[np.clip(s, 0, 32)])
    m_hi = (_LOW_MASKS32[np.clip(e - 32, 0, 32)]
            & ~_LOW_MASKS32[np.clip(s - 32, 0, 32)])
    x = (bits2[..., 1] & m_lo) ^ (bits2[..., 0] & m_hi)
    for sh in (16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint32(sh))
    return 1 - 2 * (x & np.uint32(1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Two-word channels on the device: one int64 per channel
# ---------------------------------------------------------------------------

def join2(bits2: torch.Tensor) -> torch.Tensor:
    """(..., 2) int64 [hi, lo] words -> (...) int64 channel holding all 64
    bits (orbital 63 is the sign bit)."""
    return (bits2[..., 0] << 32) | bits2[..., 1]


def split2(channel: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`join2`: (...) int64 -> (..., 2) [hi, lo] words."""
    return torch.stack([(channel >> 32) & 0xFFFFFFFF,
                        channel & 0xFFFFFFFF], -1)


def _parity64(x: torch.Tensor) -> torch.Tensor:
    """Parity of the set bits of int64 values, all 64 bits.  The shifts
    are arithmetic, but each fold only reads bits below 64 - s into the
    low s bits, so the sign fill never reaches bit 0."""
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


# (1 << k) - 1 for k = 0..64 as int64 two's complement (k = 64: all ones);
# gathered rather than shifted, so no mask overflows at orbital 63
_LOW_MASKS64 = [(1 << k) - 1 if k < 64 else -1 for k in range(65)]


def _low_masks64(device) -> torch.Tensor:
    return torch.tensor(_LOW_MASKS64, dtype=torch.int64, device=device)


def parity_between64(channel: torch.Tensor, p: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """:func:`parity_between` on 64-bit channels (int64 sign)."""
    low = _low_masks64(channel.device)
    mask = low[torch.maximum(p, q)] & ~low[torch.minimum(p, q) + 1]
    return 1 - 2 * _parity64(channel & mask)


def occupancy2(bits2: torch.Tensor, n_orb: int) -> torch.Tensor:
    """(..., 2) int64 [hi, lo] -> (..., n_orb) int64 0/1 occupations."""
    return occupancy(join2(bits2), n_orb)


def flip_orbital2(bits2: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """XOR orbital bit ``p`` of a two-word channel; ``bits2`` (..., 2)
    broadcasts against the int64 orbitals ``p`` (...)."""
    return split2(join2(bits2) ^ (1 << p))


def parity_between2(bits2: torch.Tensor, p: torch.Tensor, q: torch.Tensor
                    ) -> torch.Tensor:
    """Two-word :func:`parity_between` (the JW sign across 64 bits)."""
    return parity_between64(join2(bits2), p, q)
