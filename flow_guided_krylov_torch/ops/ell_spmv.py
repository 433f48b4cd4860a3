"""Fixed-degree ELL sparse matvec for subspace Hamiltonians.

Counterpart of ``flow_guided_krylov_tpu/ops/pallas_spmv.py``.  The
particle-conserving subspace Hamiltonian has a fixed row degree C, so
ELL is exact:

    out[i] = diag[i] * psi[i] + sum_c elems_t[c, i] * psi[tgt_t[c, i]]

with the tables stored transposed, (C, N) float32 / int32.  ``psi`` is one
vector (N,) or a stack (B, N) with B in {1, 2}: the Lanczos propagator
passes Re and Im together so the tables are read once per step.

The sum has one stated order, shared by the kernel and the plain version:
the C connections are cut into S contiguous segments
(:func:`ell_segments`, a function of (N, C)), each segment sums from 0 in
c order, and out = diag * psi + seg_0 + ... + seg_{S-1}, every product
and sum rounded separately.  So the two agree bit for bit.

* :func:`ell_spmv_reference` — the plain torch version.
* :func:`ell_spmv_cuda` — the hand-written Hopper kernel
  (``csrc/ell_spmv.cu``), built with ``nvcc`` at first use.  It keeps psi
  in shared memory when it fits (:func:`psi_fits_on_chip`) and gathers it
  through L2 otherwise.
* :func:`ell_spmv` — routes by the tensors' device: the kernel on
  ``cuda``, the plain version on ``cpu``.  A kernel that fails to build
  or launch raises.

Each of the three also takes a row block: the tables of rows [row0, row0
+ n_rows) of an operator over N states, as (C, n_rows), with psi (B, N)
whole, and returns (B, n_rows):

    out[b, i] = diag[i] * psi[b, row0 + i]
                + sum_c elems_t[c, i] * psi[b, tgt_t[c, i]].

Its segment count is the whole operator's, ``ell_segments(n_total, C)``
(``n_total`` defaults to psi's length), so every row sums in the order
of the square product and a row-sharded product
(``parallel/sharded_matvec.py``) equals it bit for bit.  The square call
is the block row0 = 0, n_rows = N.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from ..utils.build import build_library, find_nvcc
from ..utils.profiling import count

__all__ = ["ell_spmv", "ell_spmv_reference", "ell_spmv_cuda", "ell_segments", "psi_fits_on_chip", "KERNEL_SOURCE"]

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "ell_spmv.cu")

# rows x segments wanted in flight: 2^18 lanes (8,192 warps, 62 a SM on
# an H100's 132 SMs) before a row is split further
_LANES_WANTED = 1 << 18
MAX_SEGMENTS = 32
# psi bytes a block may stage in shared memory (of the 227 KB it may use,
# beside the kernel's 8 KB of partial sums)
PSI_SMEM_BYTES = 192 * 1024


def ell_segments(n: int, c: int) -> int:
    """S, the number of contiguous c-segments a row's sum is cut into: the
    smallest power of two with N * S >= 2^18 lanes, at most 32 and at most
    C (at least 1).  N2 (14,400 x 609) gets 32, the synthetic 213,444 x
    1,260 table 2."""
    s = 1
    while s < MAX_SEGMENTS and s < c and n * s < _LANES_WANTED:
        s *= 2
    return s


def psi_fits_on_chip(n: int, b: int) -> bool:
    """True when the kernel stages the b psi vectors in shared memory."""
    return 4 * b * n <= PSI_SMEM_BYTES


def ell_spmv_reference(diag: torch.Tensor, elems_t: torch.Tensor,
                       tgt_t: torch.Tensor, psi: torch.Tensor, row0: int = 0,
                       n_total: Optional[int] = None) -> torch.Tensor:
    """The kernel's sum in the kernel's order: S = ``ell_segments(n_total,
    C)`` segments, each summed from 0 over its c in order, added to diag *
    psi one after another, for rows [row0, row0 + n_rows).  One gathered
    n_rows-vector at a time (peak live memory: one gather, never a (C, N)
    product)."""
    c, n_rows = elems_t.shape
    n = psi.shape[-1]
    _check_block(row0, n_rows, n)
    own = psi.narrow(-1, row0, n_rows)
    return _rows_sum(diag, elems_t, tgt_t, psi, diag * own,
                     ell_segments(n if n_total is None else n_total, c))


def _check_block(row0: int, n_rows: int, n: int) -> None:
    if row0 < 0 or row0 + n_rows > n:
        raise ValueError(f"rows [{row0}, {row0 + n_rows}) leave psi's "
                         f"{n} states")


def _rows_sum(diag, elems_t, tgt_t, psi, acc, segs: int) -> torch.Tensor:
    """acc + seg_0 + ... + seg_{S-1}, each segment summed from 0 in c
    order over psi gathered at the targets."""
    c = elems_t.shape[0]
    seg_len = -(-c // segs)
    for s in range(segs):
        seg = torch.zeros_like(acc)
        for k in range(min(c, s * seg_len), min(c, (s + 1) * seg_len)):
            seg = seg + elems_t[k] * psi.index_select(-1, tgt_t[k])
        acc = acc + seg
    return acc


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build_library(
        "ell_spmv", [KERNEL_SOURCE],
        [find_nvcc(), "-O3", "-std=c++17",
         "-gencode", "arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.fgk_ell_spmv.argtypes = [p, p, p, p, p, i64, i64, i64, i64,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.fgk_ell_spmv.restype = ctypes.c_int
    return lib


def ell_spmv_cuda(diag: torch.Tensor, elems_t: torch.Tensor,
                  tgt_t: torch.Tensor, psi: torch.Tensor,
                  psi_on_chip: Optional[bool] = None, row0: int = 0,
                  n_total: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of ``psi``'s device.

    Takes contiguous CUDA tensors: ``diag`` f32 (n_rows,), ``elems_t`` f32
    (C, n_rows), ``tgt_t`` int32 (C, n_rows) with entries in [0, N) for
    rows [row0, row0 + n_rows) of an operator over psi's N states, ``psi``
    f32 (N,) or (B, N) with B in {1, 2}.  Returns (n_rows,) or (B,
    n_rows); the square call (row0 = 0, n_rows = N) returns a tensor
    shaped like ``psi``.  The segments are ``ell_segments(n_total, C)``
    (``n_total`` defaults to N).  ``psi_on_chip`` picks the route (psi in
    shared memory or gathered through L2); by default
    :func:`psi_fits_on_chip` decides from N.  Both routes give the same
    bits.
    """
    out = _launch(diag, elems_t, tgt_t, psi, row0, n_total, psi_on_chip)
    ell_spmv_cuda.launches += 1
    return out


ell_spmv_cuda.launches = 0


def _launch(diag, elems_t, tgt_t, psi, row0: int, n_total: Optional[int],
            psi_on_chip: Optional[bool]) -> torch.Tensor:
    """Check the tensors and launch one row block (the square product is
    the block of all rows)."""
    c, n_rows = elems_t.shape
    n = psi.shape[-1]
    b = 1 if psi.dim() == 1 else psi.shape[0]
    for name, t, dtype, shape in (("diag", diag, torch.float32, (n_rows,)),
                                  ("elems_t", elems_t, torch.float32,
                                   (c, n_rows)),
                                  ("tgt_t", tgt_t, torch.int32, (c, n_rows)),
                                  ("psi", psi, torch.float32,
                                   (n,) if psi.dim() == 1 else (b, n))):
        if t.device != psi.device or t.device.type != "cuda":
            raise ValueError(f"{name} must lie on psi's CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b not in (1, 2):
        raise ValueError(f"psi must stack 1 or 2 vectors, got {b}")
    _check_block(row0, n_rows, n)
    fits = psi_fits_on_chip(n, b)
    if psi_on_chip is None:
        psi_on_chip = fits
    elif psi_on_chip and not fits:
        raise ValueError(f"psi of {b} x {n} floats exceeds the "
                         f"{PSI_SMEM_BYTES}-byte shared-memory route")
    segs = ell_segments(n if n_total is None else n_total, c)
    lib = _library()
    out = psi.new_empty(psi.shape[:-1] + (n_rows,))
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = lib.fgk_ell_spmv(diag.data_ptr(), elems_t.data_ptr(),
                              tgt_t.data_ptr(), psi.data_ptr(),
                              out.data_ptr(), n_rows, n, row0, c, b, segs,
                              int(psi_on_chip), stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: cudaError {rc}")
    return out


def ell_spmv(diag: torch.Tensor, elems_t: torch.Tensor, tgt_t: torch.Tensor,
             psi: torch.Tensor, row0: int = 0,
             n_total: Optional[int] = None) -> torch.Tensor:
    """ELL matvec over (C, n_rows) tables on ``psi``'s device (rows
    [row0, row0 + n_rows) of an ``n_total``-row operator).  Counts
    ``ell.launches`` (one a product: a kernel launch on a card) and
    ``ell.vectors`` (the vectors it multiplies)."""
    count("ell.launches")
    count("ell.vectors", 1 if psi.dim() == 1 else psi.shape[0])
    if psi.device.type == "cuda":
        return ell_spmv_cuda(diag, elems_t, tgt_t, psi, row0=row0,
                             n_total=n_total)
    if psi.device.type == "cpu":
        return ell_spmv_reference(diag, elems_t, tgt_t, psi, row0, n_total)
    raise ValueError(f"no ELL SpMV for device {psi.device}")
