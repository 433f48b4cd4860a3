"""Mesh-sharded statevector Trotter rotations.

Counterpart of ``flow_guided_krylov_tpu/parallel/sharded_trotter.py``.
The 2^n statevector is held as ``mesh.size`` blocks of 2^(n - log2 d)
amplitudes: block d (on entry d's device) holds the amplitudes whose top
log2 d bits equal d.  A Pauli word exp(-i theta P), P = i^n_y X^x Z^z,
then takes one of two forms:

* **x inside the block** (every X/Y bit below the block's bits): each
  block rotates on its own through the x_sweep kernel
  (``ops/x_sweep.py``, its plain version on a CPU tensor).  The word's Z
  bits above the block only multiply P by (-1)^parity(d & z_hi), a sign
  that folds into theta, so the kernel is unchanged and only the word
  tables differ from block to block.  Runs of consecutive such words go
  through ``make_gathered_sweeps`` over the block's bits.
* **x reaching above the block**: block d needs the partner block
  d ^ x_hi, which is copied to d's device (a peer copy between cards, a
  no-op on a logical mesh); the rotation then runs elementwise in torch
  with the sign from the global index.  The JAX package computes these
  words in XLA (``_xor_permute`` + ``ppermute``), not in Pallas.

The half phase exp(-i dt/2 D) of the diagonal words is computed per block
from the global index (``krylov/skqd.py::_half_phase`` over a block).
Each word is rounded as the single-device substep rounds it, so a sharded
substep gives the single-device bits.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.bits import _parity32
from ..ops.x_sweep import _cos_sin_f32, _xor_permute, make_gathered_sweeps
from .mesh import Mesh, gather, to

__all__ = ["mesh_supports_statevector", "make_sharded_substep",
           "shard_statevector", "gather_statevector"]

Blocks = List[torch.Tensor]


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def mesh_supports_statevector(mesh: Mesh, n_qubits: int) -> bool:
    """The JAX package's rule: both axis sizes powers of two and each
    block at least 2^7 amplitudes (a mesh of one entry: False)."""
    if mesh is None or mesh.size <= 1:
        return False
    if not all(_is_pow2(mesh.shape[a]) for a in ("data", "basis")):
        return False
    return n_qubits - int(np.log2(mesh.size)) >= 7


def _shift(mesh: Mesh, n_qubits: int) -> int:
    return n_qubits - int(np.log2(mesh.size))


def shard_statevector(mesh: Mesh, re: torch.Tensor, im: torch.Tensor
                      ) -> Tuple[Blocks, Blocks]:
    """(re, im) of 2^n amplitudes -> their blocks, block d on entry d's
    device."""
    local = re.shape[0] // mesh.size
    return ([to(re[d * local:(d + 1) * local].contiguous(), dev)
             for d, dev in enumerate(mesh.devices)],
            [to(im[d * local:(d + 1) * local].contiguous(), dev)
             for d, dev in enumerate(mesh.devices)])


def gather_statevector(mesh: Mesh, re: Blocks, im: Blocks
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks concatenated on the first device."""
    return gather(mesh, re), gather(mesh, im)


def _half_phase_block(diag: Sequence[Tuple[float, int]], shift: int, d: int,
                      dt_sub: float, device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(-i dt_sub/2 D) over block d's global indices, D summed in
    float32 in the order of the single-device phase, each distinct angle's
    cos and sin taken in float64 on the host and rounded to float32."""
    idx = (d << shift) + torch.arange(1 << shift, dtype=torch.int64,
                                      device=device)
    D = torch.zeros(1 << shift, dtype=torch.float32, device=device)
    for c, zm in diag:
        sign = 1.0 - 2.0 * _parity32(idx & zm).to(torch.float32)
        D = D + float(np.float32(c)) * sign
    ang, where = torch.unique(0.5 * dt_sub * D, return_inverse=True)
    ang = ang.double().cpu().numpy()
    cos = torch.as_tensor(np.cos(ang).astype(np.float32), device=device)
    sin = torch.as_tensor(np.sin(ang).astype(np.float32), device=device)
    return cos[where], -sin[where]


def _cross_rotation(mesh: Mesh, re: Blocks, im: Blocks, shift: int,
                    word: Tuple[float, int, int, int]
                    ) -> Tuple[Blocks, Blocks]:
    """One word whose x reaches above the blocks: block d reads block
    d ^ x_hi (copied to its device) permuted by x's low bits, and rotates
    in torch with the rounding of ``ops/x_sweep._pauli_rotation_pair``."""
    theta, xm, zm, ny = word
    ct, st = _cos_sin_f32(theta)
    lo, hi = xm & ((1 << shift) - 1), xm >> shift
    out_re, out_im = [], []
    for d, dev in enumerate(mesh.devices):
        xr = _xor_permute(to(re[d ^ hi], dev), lo, shift)
        xi = _xor_permute(to(im[d ^ hi], dev), lo, shift)
        r, i = re[d], im[d]
        if zm == 0 and ny % 4 == 0:
            out_re.append(ct * r + st * xi)
            out_im.append(ct * i - st * xr)
            continue
        idx = (d << shift) + torch.arange(1 << shift, dtype=torch.int64,
                                          device=dev)
        s = 1.0 - 2.0 * _parity32((idx ^ xm) & zm).to(r.dtype)
        p_re, p_im = {0: (xr, xi), 1: (-xi, xr), 2: (-xr, -xi),
                      3: (xi, -xr)}[ny % 4]
        p_re = s * p_re
        p_im = s * p_im
        out_re.append(ct * r + st * p_im)
        out_im.append(ct * i - st * p_re)
    return out_re, out_im


def _block_sweeps(mesh: Mesh, shift: int, run: List[Tuple]
                  ) -> List[Tuple[List[Tuple], Callable]]:
    """[(words, sweep)] of block d for a run of in-block words: each
    word's Z bits above the block fold into the sign of its theta for
    block d, and ``sweep`` applies those words to the block."""
    low = (1 << shift) - 1
    steps = []
    for d in range(mesh.size):
        words = [(-t if bin(d & (zm >> shift)).count("1") & 1 else t,
                  xm, zm & low, ny) for t, xm, zm, ny in run]
        steps.append((words, make_gathered_sweeps(shift, words)))
    return steps


def make_sharded_substep(mesh: Mesh, n_qubits: int,
                         diag_terms: List[Tuple[float, int]],
                         offd_terms: List[Tuple[float, int, int, int]],
                         dt_sub: float):
    """(substep(re, im, hr, hi), hp_re, hp_im) for a second-order Trotter
    substep over a mesh-sharded statevector: diag . words(forward) .
    words(reversed) . diag, every argument and result a list of blocks.
    ``substep.block_runs`` lists each run of in-block words as block d's
    [(folded words, sweep)], so a check can hold a block's sweep against
    the plain rotations of the same words.

    ``diag_terms`` = [(coeff, z_mask)], ``offd_terms`` = [(coeff, x_mask,
    z_mask, n_y)] rotated at half angle, in the order given (the caller's
    order; the single-device substep of ``krylov/skqd.py`` puts the words
    inside the contiguous tile first)."""
    if not mesh_supports_statevector(mesh, n_qubits):
        raise ValueError(f"the {n_qubits}-qubit statevector does not shard "
                         f"over a mesh of shape {mesh.shape}")
    shift = _shift(mesh, n_qubits)
    words = [(c * dt_sub / 2, xm, zm, ny) for c, xm, zm, ny in offd_terms]
    seq = words + words[::-1]
    # the ordered list cut into runs: in-block words through per-block
    # sweeps, each cross-block word on its own
    plan: List[Tuple[str, object]] = []
    for w in seq:
        if w[1] >> shift:
            plan.append(("cross", w))
        elif plan and plan[-1][0] == "block":
            plan[-1][1].append(w)
        else:
            plan.append(("block", [w]))
    steps = [(kind, _block_sweeps(mesh, shift, arg) if kind == "block"
              else arg) for kind, arg in plan]
    phases = [_half_phase_block(diag_terms, shift, d, dt_sub, dev)
              for d, dev in enumerate(mesh.devices)]
    hp_re = [p[0] for p in phases]
    hp_im = [p[1] for p in phases]

    def substep(re: Blocks, im: Blocks, hr: Blocks, hi: Blocks
                ) -> Tuple[Blocks, Blocks]:
        re, im = _mul(re, im, hr, hi)
        for kind, arg in steps:
            if kind == "cross":
                re, im = _cross_rotation(mesh, re, im, shift, arg)
            else:
                pairs = [sweep(r, i) for (_, sweep), r, i
                         in zip(arg, re, im)]
                re, im = [p[0] for p in pairs], [p[1] for p in pairs]
        return _mul(re, im, hr, hi)

    substep.block_runs = [arg for kind, arg in steps if kind == "block"]
    return substep, hp_re, hp_im


def _mul(re: Blocks, im: Blocks, hr: Blocks, hi: Blocks
         ) -> Tuple[Blocks, Blocks]:
    """(re + i im) * (hr + i hi), block by block."""
    return ([r * a - i * b for r, i, a, b in zip(re, im, hr, hi)],
            [r * b + i * a for r, i, a, b in zip(re, im, hr, hi)])
