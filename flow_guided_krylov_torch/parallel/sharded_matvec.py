"""Row-sharded Hamiltonian products and Lanczos over a device mesh.

Counterpart of ``flow_guided_krylov_tpu/parallel/sharded_matvec.py``.  The
subspace Hamiltonian's rows (the determinant axis) are cut into one block
per mesh entry, padded to a multiple of ``mesh.size`` as the JAX package
pads, and each block lives on its entry's device.  A product sends the
vector to every entry's device (a no-op on a logical mesh), multiplies
there, and copies the blocks of the result back to the first device,
where they are concatenated and the padding dropped.  The Lanczos
vectors live on the first device at the subspace's own length.

* dense row blocks: :func:`shard_hamiltonian_rows`,
  :func:`sharded_matvec_fn`, :func:`sharded_lanczos_expm`,
  :func:`sharded_lanczos_ground_state` (the JAX functions);
* ELL row blocks: :class:`ShardedEll`, built block by block on the
  entries' devices (``krylov/skqd.py::_build_ell_device``), each block's
  product through the row-block form of the ELL kernel
  (``ops/ell_spmv.py::ell_spmv``) on its own device.  Its segment
  count is the whole operator's, so a sharded product, and a sharded
  evolve, equals the unsharded one bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.ell_spmv import ell_spmv
from .mesh import Mesh, blocks_of, gather, split_rows, to

__all__ = ["RowBlocks", "ShardedEll", "shard_hamiltonian_rows",
           "sharded_matvec_fn", "sharded_lanczos_expm",
           "sharded_lanczos_ground_state"]


@dataclass
class RowBlocks:
    """A dense (n, n) H as ``mesh.size`` row blocks of ``rows`` rows each,
    block d on ``mesh.devices[d]`` (the last blocks zero-padded)."""
    mesh: Mesh
    blocks: List[torch.Tensor]
    n: int


def shard_hamiltonian_rows(mesh: Mesh,
                           h_dense: Union[torch.Tensor, np.ndarray]
                           ) -> RowBlocks:
    """Place H's rows over the mesh: block d holds rows [d·r, (d+1)·r) of
    H padded with zero rows to a multiple of ``mesh.size`` (r rows a
    block), as float32 on entry d's device.  A host array crosses to each
    device one block at a time."""
    n = h_dense.shape[0]
    rows, _ = split_rows(mesh, n)
    blocks = []
    for (row0, _), dev in zip(blocks_of(mesh, n), mesh.devices):
        part = h_dense[row0:min(n, row0 + rows)]
        blk = torch.zeros((rows, h_dense.shape[1]), dtype=torch.float32,
                          device=dev)
        if len(part):
            blk[:len(part)] = to(torch.as_tensor(part, dtype=torch.float32),
                                 dev)
        blocks.append(blk)
    return RowBlocks(mesh, blocks, n)


def sharded_matvec_fn(mesh: Mesh):
    """``mv(h_sharded, x)``: x (n,) or (B, n) on the first device, sent to
    every block's device; returns H x on the first device."""

    def mv(h_sharded: RowBlocks, x: torch.Tensor) -> torch.Tensor:
        parts = [to(x, blk.device) @ blk.T for blk in h_sharded.blocks]
        return gather(mesh, parts, h_sharded.n)

    return mv


def sharded_lanczos_expm(mesh: Mesh, h_sharded: RowBlocks,
                         psi_re: torch.Tensor, psi_im: torch.Tensor,
                         dt: float, m: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(-i dt H)|psi> with the matvec sharded over the mesh (the
    Lanczos propagator of ``krylov/skqd.py`` on the first device)."""
    from ..krylov.skqd import _lanczos_expm_impl
    mv = sharded_matvec_fn(mesh)
    return _lanczos_expm_impl(lambda v: mv(h_sharded, v), psi_re, psi_im,
                              dt, m)


def sharded_lanczos_ground_state(mesh: Mesh, h_sharded: RowBlocks,
                                 m: int = 60,
                                 v0: Optional[torch.Tensor] = None
                                 ) -> Tuple[float, torch.Tensor]:
    """Lowest eigenpair with row-sharded matvecs: an m-step Lanczos with
    full reorthogonalization on the first device; the tridiagonal is
    diagonalized in float64, as every reported small ``eigh`` of the port
    is (``postprocessing/eigensolver.py::_ritz_ground``)."""
    from ..postprocessing.eigensolver import (_lanczos_tridiag_mv,
                                              _ritz_ground)
    n = h_sharded.n
    m = min(m, n)
    if v0 is None:
        v0 = torch.ones(n, dtype=torch.float32, device=mesh.first)
    mv = sharded_matvec_fn(mesh)
    e, v = _ritz_ground(*_lanczos_tridiag_mv(lambda x: mv(h_sharded, x),
                                             v0, m))
    return float(e), v


class ShardedEll:
    """ELL tables (diag, elems_t, tgt_t) of an n-row operator as
    ``mesh.size`` row blocks: block d holds rows [row0_d, row0_d + r) as
    (r,), (C, r), (C, r) on entry d's device, the last blocks padded with
    zero rows (diag 0, element 0, target 0) up to n + pad rows."""

    def __init__(self, mesh: Mesh, blocks, n: int, c: int, pad: int):
        self.mesh = mesh
        self.blocks = blocks            # [(row0, diag, elems_t, tgt_t)]
        self.n = n
        self.c = c
        self.pad = pad

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """H v for v (n,) or (B, n), B in {1, 2}, on the first device:
        psi padded to n + pad and sent to each block's device, one
        row-block kernel launch a block (its plain version on the CPU),
        with the segments of the whole n-row operator; the blocks
        concatenated on the first device, cut to n."""
        vp = torch.nn.functional.pad(v, (0, self.pad)) if self.pad else v
        parts = [ell_spmv(d, e, t, to(vp, d.device), row0, n_total=self.n)
                 for row0, d, e, t in self.blocks]
        return gather(self.mesh, parts, self.n)

