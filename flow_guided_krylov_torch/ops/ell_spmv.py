"""Fixed-degree ELL sparse matvec for subspace Hamiltonians.

Counterpart of ``flow_guided_krylov_tpu/ops/pallas_spmv.py``.  The
particle-conserving subspace Hamiltonian has a fixed row degree C, so
ELL is exact:

    out[i] = diag[i] * psi[i] + sum_c elems_t[c, i] * psi[tgt_t[c, i]]

with the tables stored transposed, (C, N) float32 / int32.  ``psi`` is one
vector (N,) or a stack (B, N) with B in {1, 2}: the Lanczos propagator
passes Re and Im together so the tables are read once per step.

* :func:`ell_spmv_reference` — the plain torch version.
* :func:`ell_spmv_cuda` — the hand-written Hopper kernel
  (``csrc/ell_spmv.cu``), built with ``nvcc`` at first use.
* :func:`ell_spmv` — routes by the tensors' device: the kernel on
  ``cuda``, the plain version on ``cpu``.  A kernel that fails to build
  or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..utils.build import build_library, find_nvcc

__all__ = ["ell_spmv", "ell_spmv_reference", "ell_spmv_cuda",
           "KERNEL_SOURCE"]

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "ell_spmv.cu")


def ell_spmv_reference(diag: torch.Tensor, elems_t: torch.Tensor,
                       tgt_t: torch.Tensor, psi: torch.Tensor
                       ) -> torch.Tensor:
    """Loop over the C connection rows, one gathered N-vector at a time
    (peak live memory: one gather, never a (C, N) product)."""
    acc = diag * psi
    for c in range(elems_t.shape[0]):
        acc = acc + elems_t[c] * psi.index_select(-1, tgt_t[c])
    return acc


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build_library(
        "ell_spmv", [KERNEL_SOURCE],
        [find_nvcc(), "-O3", "-std=c++17",
         "-gencode", "arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])
    p = ctypes.c_void_p
    lib.fgk_ell_spmv.argtypes = [p, p, p, p, p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int, p]
    lib.fgk_ell_spmv.restype = ctypes.c_int
    return lib


def ell_spmv_cuda(diag: torch.Tensor, elems_t: torch.Tensor,
                  tgt_t: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of ``psi``'s device.

    Takes contiguous CUDA tensors: ``diag`` f32 (N,), ``elems_t`` f32
    (C, N), ``tgt_t`` int32 (C, N) with entries in [0, N), ``psi`` f32
    (N,) or (B, N) with B in {1, 2}.  Returns a new tensor shaped like
    ``psi``.
    """
    c, n = elems_t.shape
    b = 1 if psi.dim() == 1 else psi.shape[0]
    for name, t, dtype, shape in (("diag", diag, torch.float32, (n,)),
                                  ("elems_t", elems_t, torch.float32, (c, n)),
                                  ("tgt_t", tgt_t, torch.int32, (c, n)),
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
    lib = _library()
    out = torch.empty_like(psi)
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = lib.fgk_ell_spmv(diag.data_ptr(), elems_t.data_ptr(),
                              tgt_t.data_ptr(), psi.data_ptr(),
                              out.data_ptr(), n, c, b, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: cudaError {rc}")
    ell_spmv_cuda.launches += 1
    return out


ell_spmv_cuda.launches = 0


def ell_spmv(diag: torch.Tensor, elems_t: torch.Tensor, tgt_t: torch.Tensor,
             psi: torch.Tensor) -> torch.Tensor:
    """ELL matvec over (C, N) tables on ``psi``'s device."""
    if psi.device.type == "cuda":
        return ell_spmv_cuda(diag, elems_t, tgt_t, psi)
    if psi.device.type == "cpu":
        return ell_spmv_reference(diag, elems_t, tgt_t, psi)
    raise ValueError(f"no ELL SpMV for device {psi.device}")
