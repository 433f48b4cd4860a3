"""A ('data', 'basis') device mesh held in one process.

Counterpart of ``flow_guided_krylov_tpu/parallel/mesh.py``.  The JAX
package has a single controller: ``make_mesh`` arranges the process's
devices as a ('data', 'basis') grid, and every ``mesh=`` argument takes
that object.  The port keeps that shape in one process: a :class:`Mesh`
is an ordered tuple of ``torch.device`` entries with the same two axis
sizes, and the sharded paths place one block of rows (or of a
statevector) on each entry's device, work each block there, and bring the
results to the first entry's device.

Entries may repeat.  A mesh of four ``cuda:0`` entries (a logical mesh)
runs the sharded code on one card, and a mesh of eight ``cpu`` entries
runs it in a CPU test; on a host of four cards ``cuda:0..3`` exchange the
blocks by peer copies.  Memory budgets count each physical device once
(:attr:`Mesh.n_physical`): a logical mesh gains no memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "make_mesh", "canonical", "split_rows", "blocks_of",
           "gather", "to", "peer_bytes"]


@dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major ('data', 'basis') order: entry
    d = data_index * basis + basis_index."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def n_physical(self) -> int:
        """Distinct devices: what memory budgets scale with."""
        return len(set(self.devices))


def make_mesh(n_devices: Optional[int] = None,
              basis_parallel: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'basis') mesh over ``devices`` (by default ``cuda:0`` ..
    ``cuda:{n-1}``), cut to the first ``n_devices``.

    ``basis_parallel`` defaults to 2 when the entry count is an even
    number > 2, else 1, as in the JAX package; a count it does not divide
    raises.  Asking for more CUDA devices than the host has raises: a
    mesh is never shrunk.  Repeated entries are allowed (a logical
    mesh)."""
    if devices is None:
        n = 1 if n_devices is None else int(n_devices)
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(
                f"a mesh of {n} CUDA devices needs {n} cards, this host has "
                f"{have}; pass devices= for a logical mesh (e.g. "
                f"['cuda:0'] * {n})")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [canonical(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"{n_devices} mesh entries asked, "
                             f"{len(devices)} devices given")
        devices = devices[:n_devices]
    for d in devices:
        if d.type == "cuda" and (not torch.cuda.is_available()
                                 or (d.index or 0)
                                 >= torch.cuda.device_count()):
            raise RuntimeError(f"{d} is not a device of this host")
    n = len(devices)
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if basis_parallel is None:
        basis_parallel = 2 if (n > 2 and n % 2 == 0) else 1
    if n % basis_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"basis_parallel={basis_parallel}")
    return Mesh(tuple(devices), {"data": n // basis_parallel,
                                 "basis": basis_parallel})


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card, as a
    tensor placed there reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def split_rows(mesh: Mesh, n: int) -> Tuple[int, int]:
    """(rows a block, padding): n rows padded to a multiple of
    ``mesh.size``, as the JAX package pads its row-sharded tables."""
    pad = (-n) % mesh.size
    return (n + pad) // mesh.size, pad


# bytes moved between two distinct devices by the mesh helpers
_PEER = {"bytes": 0}


def peer_bytes(reset: bool = False) -> int:
    """Bytes the sharded paths copied between distinct devices since the
    last reset (0 on a logical mesh)."""
    n = _PEER["bytes"]
    if reset:
        _PEER["bytes"] = 0
    return n


def to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (a no-op on its own device), counting the bytes
    of a copy between two devices."""
    if t.device == device:
        return t
    if t.device.type != "cpu" or device.type != "cpu":
        _PEER["bytes"] += t.numel() * t.element_size()
    return t.to(device)


def gather(mesh: Mesh, parts: Sequence[torch.Tensor], n: Optional[int] = None,
           dim: int = -1) -> torch.Tensor:
    """The blocks copied to the first device and concatenated along
    ``dim``, cut to ``n`` entries (dropping the padding)."""
    out = torch.cat([to(p, mesh.first) for p in parts], dim)
    return out if n is None else out.narrow(dim, 0, n)


def blocks_of(mesh: Mesh, n: int) -> List[Tuple[int, int]]:
    """[(row0, rows)] of each entry's block of n rows padded to a multiple
    of ``mesh.size``; a block may run past n into the padding."""
    rows, _ = split_rows(mesh, n)
    return [(d * rows, rows) for d in range(mesh.size)]
