"""Carry the JAX package's state into the port.

The system's "weights" are its integral tables, the ELL structure of the
subspace Hamiltonian, and a spin Hamiltonian's couplings.  These functions
take them as NumPy arrays (or any object exposing the same fields), so both
packages can compute from identical inputs; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .ops.excitations import ExcitationSpec
from .ops.slater import SlaterTables

__all__ = ["tables_from_jax", "ell_from_jax", "spin_hamiltonian_from_jax"]

_TABLE_FIELDS = ("n_orb", "n_alpha", "n_beta", "e_nuc", "h1", "h2", "jj",
                 "ex", "jmat", "kmat", "spec_a", "spec_b", "ab_grid")


def _get(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _spec(obj: Any) -> ExcitationSpec:
    return ExcitationSpec(n_orb=int(_get(obj, "n_orb")), k=int(_get(obj, "k")),
                          singles=np.asarray(_get(obj, "singles"), np.int32),
                          doubles=np.asarray(_get(obj, "doubles"), np.int32))


def tables_from_jax(obj: Any) -> SlaterTables:
    """The port's ``SlaterTables`` from an object or dict holding the JAX
    ``SlaterTables`` fields (``spec_a``/``spec_b`` likewise, with
    ``n_orb``, ``k``, ``singles``, ``doubles``)."""
    f = {name: _get(obj, name) for name in _TABLE_FIELDS}
    return SlaterTables(
        n_orb=int(f["n_orb"]), n_alpha=int(f["n_alpha"]),
        n_beta=int(f["n_beta"]), e_nuc=float(f["e_nuc"]),
        h1=np.asarray(f["h1"], np.float64), h2=np.asarray(f["h2"], np.float64),
        jj=np.asarray(f["jj"], np.float64), ex=np.asarray(f["ex"], np.float64),
        jmat=np.asarray(f["jmat"], np.float64),
        kmat=np.asarray(f["kmat"], np.float64),
        spec_a=_spec(f["spec_a"]), spec_b=_spec(f["spec_b"]),
        ab_grid=np.asarray(f["ab_grid"], np.int32))


def ell_from_jax(diag: np.ndarray, elems_t: np.ndarray, tgt_t: np.ndarray,
                 device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ELL (diag (N,), elems_t (C, N), tgt_t (C, N)) as contiguous
    float32 / float32 / int32 tensors on ``device``."""
    def put(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    return (put(diag, torch.float32), put(elems_t, torch.float32),
            put(tgt_t, torch.int32))


def spin_hamiltonian_from_jax(obj: Any, device):
    """The port's spin Hamiltonian on ``device`` rebuilt from a JAX
    ``TransverseFieldIsing`` or ``HeisenbergHamiltonian`` (or any object
    of a class of the same name with the same fields)."""
    from .hamiltonians.spin import HeisenbergHamiltonian, TransverseFieldIsing
    kind = type(obj).__name__
    n = int(obj.n_sites)
    if kind == "TransverseFieldIsing":
        return TransverseFieldIsing(n, V=float(obj.V), h=float(obj.h),
                                    L=int(obj.L), periodic=bool(obj.periodic),
                                    device=device)
    if kind == "HeisenbergHamiltonian":
        return HeisenbergHamiltonian(
            n, Jx=float(obj.Jx), Jy=float(obj.Jy), Jz=float(obj.Jz),
            h_x=np.array(obj.h_x, np.float64),
            h_y=np.array(obj.h_y, np.float64),
            h_z=np.array(obj.h_z, np.float64),
            periodic=bool(obj.periodic), device=device)
    raise TypeError(f"no port counterpart for spin Hamiltonian {kind}")
