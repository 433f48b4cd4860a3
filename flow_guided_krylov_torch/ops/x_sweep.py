"""Fused sweep of Pauli-word rotations inside statevector tiles.

Counterpart of ``flow_guided_krylov_tpu/ops/pallas_trotter.py``.  A sweep
applies exp(-i theta_w P_w) for a list of words (theta, x_mask, z_mask,
n_y), in order or reversed, to a 2^n statevector held as a (re, im)
float32 pair.  Every word's x_mask lies inside one tile of 2^T
consecutive amplitudes, so the whole list costs one pass over the state.

* :func:`_pauli_rotation_pair` — one word's rotation in plain torch, with
  the kernel's rounding: the primitive of the plain version and of the
  Trotter propagator's words outside the tile.
* :func:`x_sweep_reference` — the plain torch version: the words one after
  another through :func:`_pauli_rotation_pair`.
* :func:`x_sweep_cuda` — the hand-written Hopper kernel
  (``csrc/x_sweep.cu``), built with ``nvcc`` at first use.
* :func:`make_x_sweep` — the JAX name and contract: a callable
  ``(re, im) -> (re, im)`` that routes by the tensors' device, the kernel
  on ``cuda`` and the plain version on ``cpu``.  A kernel that fails to
  build or launch raises.

The JAX package routes its sweep only on a TPU and only when an
environment switch asks for it, because there each XOR became a
permutation matmul and ran 20x slower than XLA's per-rotation path.  On
Hopper the XOR is a shared-memory address, so the Trotter propagator uses
the kernel whenever the state lies on a card.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.build import build_library, find_nvcc
from .bits import _parity32

__all__ = ["TILE_BITS", "MAX_TILE_BITS", "make_x_sweep", "x_sweep_reference",
           "x_sweep_cuda", "word_table", "KERNEL_SOURCE"]

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "x_sweep.cu")

# log2 of the tile's amplitude count.  The kernel holds a tile in shared
# memory at 8 bytes an amplitude, so 14 (128 KB) is the largest it takes.
# 14 beat 13 on a TFIM-24 evolve on an H100: a sweep over 13 bits is
# faster, but leaves one more word to the plain path (csrc/x_sweep.cu).
TILE_BITS = 14
MAX_TILE_BITS = 14

Word = Tuple[float, int, int, int]           # (theta, x_mask, z_mask, n_y)


def _pauli_masks(word: str) -> Tuple[int, int, int]:
    """Pauli word (site q at position q) -> (x_mask, z_mask, n_y)."""
    x_mask = z_mask = n_y = 0
    for q, p in enumerate(word.upper()):
        if p in "XY":
            x_mask |= 1 << q
        if p in "ZY":
            z_mask |= 1 << q
        if p == "Y":
            n_y += 1
    return x_mask, z_mask, n_y


def _xor_permute(psi: torch.Tensor, x_mask: int, n_qubits: int
                 ) -> torch.Tensor:
    """psi[k ^ x_mask]: one reflection of a (left, 2, right) view per set
    bit of the mask."""
    for q in range(n_qubits):
        if (x_mask >> q) & 1:
            v = psi.view(1 << (n_qubits - 1 - q), 2, 1 << q)
            psi = v.flip(1).view(-1)
    return psi


def _cos_sin_f32(theta: float) -> Tuple[float, float]:
    """cos and sin of ``theta`` taken in float64 on the host and rounded to
    float32, as the kernel receives them (:func:`word_table`)."""
    return float(np.float32(np.cos(theta))), float(np.float32(np.sin(theta)))


def _pauli_rotation_pair(re: torch.Tensor, im: torch.Tensor, theta: float,
                         x_mask: int, z_mask: int, n_y: int, n_qubits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """psi' = exp(-i theta P) psi = cos(theta) psi - i sin(theta) (P psi)
    on a (re, im) float32 pair, with (P psi)[k] = s * i^n_y * psi[k ^ x],
    s = (-1)^parity((k ^ x) & z).  Products and sums are rounded one by
    one, in the order the kernel uses."""
    ct, st = _cos_sin_f32(theta)
    xr = _xor_permute(re, x_mask, n_qubits)
    xi = _xor_permute(im, x_mask, n_qubits)
    if z_mask == 0 and n_y % 4 == 0:
        # pure-X word (every TFIM off-diagonal term): no sign vector
        return ct * re + st * xi, ct * im - st * xr
    idx = torch.arange(1 << n_qubits, dtype=torch.int64, device=re.device)
    s = 1.0 - 2.0 * _parity32((idx ^ x_mask) & z_mask).to(re.dtype)
    # i^n_y * (xr + i xi), exact: the phase only swaps and negates
    p_re, p_im = {0: (xr, xi), 1: (-xi, xr), 2: (-xr, -xi),
                  3: (xi, -xr)}[n_y % 4]
    p_re = s * p_re
    p_im = s * p_im
    return ct * re + st * p_im, ct * im - st * p_re


def x_sweep_reference(re: torch.Tensor, im: torch.Tensor,
                      words: Sequence[Word], n_qubits: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The words applied one after another, in the order given."""
    for theta, xm, zm, ny in words:
        re, im = _pauli_rotation_pair(re, im, theta, xm, zm, ny, n_qubits)
    return re, im


def word_table(words: Sequence[Word]) -> np.ndarray:
    """(W, 5) int32 records (cos, sin, x_mask, z_mask, n_y mod 4) in the
    kernel's layout; cos and sin are taken in float64 and rounded to
    float32, with their bits stored in the first two columns."""
    table = np.zeros((len(words), 5), np.int32)
    cs = table[:, :2].view(np.float32)
    for w, (theta, xm, zm, ny) in enumerate(words):
        cs[w] = (np.cos(theta), np.sin(theta))
        table[w, 2:] = (xm, zm, ny % 4)
    return table


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build_library(
        "x_sweep", [KERNEL_SOURCE],
        [find_nvcc(), "-O3", "-std=c++17",
         "-gencode", "arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])
    p = ctypes.c_void_p
    lib.fgk_x_sweep.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, p]
    lib.fgk_x_sweep.restype = ctypes.c_int
    return lib


def x_sweep_cuda(re: torch.Tensor, im: torch.Tensor, table: torch.Tensor,
                 n_qubits: int, tile_bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream of ``re``'s device.

    Takes contiguous CUDA tensors: ``re`` and ``im`` float32
    (2^n_qubits,), 16-byte aligned, and ``table`` int32 (W, 5) from
    :func:`word_table` with every x_mask in (0, 2^tile_bits).  Returns new
    (re, im) tensors.
    """
    dim = 1 << n_qubits
    if not 1 <= tile_bits <= min(n_qubits, MAX_TILE_BITS) or n_qubits > 31:
        raise ValueError(f"tile_bits {tile_bits} must lie in "
                         f"[1, min({n_qubits}, {MAX_TILE_BITS})] and "
                         f"n_qubits {n_qubits} <= 31")
    for name, t, dtype, shape in (("re", re, torch.float32, (dim,)),
                                  ("im", im, torch.float32, (dim,)),
                                  ("table", table, torch.int32,
                                   (table.shape[0], 5))):
        if t.device != re.device or t.device.type != "cuda":
            raise ValueError(f"{name} must lie on re's CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError("re and im must start 16-byte aligned (the kernel "
                         "moves them with 16-byte loads)")
    lib = _library()
    re_out = torch.empty_like(re)
    im_out = torch.empty_like(im)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        rc = lib.fgk_x_sweep(re.data_ptr(), im.data_ptr(), re_out.data_ptr(),
                             im_out.data_ptr(), table.data_ptr(),
                             table.shape[0], n_qubits, tile_bits, stream)
    if rc != 0:
        raise RuntimeError(f"x_sweep kernel launch failed: cudaError {rc}")
    x_sweep_cuda.launches += 1
    return re_out, im_out


x_sweep_cuda.launches = 0


def make_x_sweep(n_qubits: int, words: Sequence[Word],
                 tile_bits: int = TILE_BITS, reverse: bool = False
                 ) -> Optional[Callable]:
    """A callable ``(re, im) -> (re, im)`` applying exp(-i theta P) for
    every word (theta, x_mask, z_mask, n_y) in order (reversed when
    ``reverse``), every x_mask inside a tile of 2^min(tile_bits, n_qubits)
    amplitudes.

    Returns None when a word's x_mask is <= 0 or leaves the tile.  The
    callable launches the kernel for tensors on a CUDA device and runs
    :func:`x_sweep_reference` for tensors on the CPU.
    """
    tile_bits = min(tile_bits, n_qubits)
    if any(w[1] <= 0 or w[1] >= 1 << tile_bits for w in words):
        return None
    seq = list(reversed(words)) if reverse else list(words)
    table = word_table(seq)
    on_device = {}

    def sweep(re: torch.Tensor, im: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        if re.device.type == "cuda":
            t = on_device.get(re.device)
            if t is None:
                t = on_device[re.device] = torch.as_tensor(table,
                                                           device=re.device)
            return x_sweep_cuda(re, im, t, n_qubits, tile_bits)
        if re.device.type == "cpu":
            return x_sweep_reference(re, im, seq, n_qubits)
        raise ValueError(f"no x_sweep for device {re.device}")

    return sweep
