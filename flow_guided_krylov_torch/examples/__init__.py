"""The port's entry points: the example CLIs, the headline bench and the
compile-check entry.

Each module is the counterpart of the JAX package's script of the same
name (``examples/*.py``, ``bench.py``, ``__graft_entry__.py::entry``) with
the same functions, arguments, defaults, printed tables and results keys,
and runs as ``python -m flow_guided_krylov_torch.examples.<name>``:

* ``benchmark``                 — the molecular benchmark (pipeline or
                                  ``--pt2-only`` Selected-CI per molecule)
* ``bench``                     — one JSON line: the connection rate over
                                  the 10:7 space and the N2 / CH4 walls to
                                  chemical accuracy
* ``large_system_benchmark``    — active-space systems: pipeline, SCI and
                                  SCI + restricted SKQD, CCSD(T) oracle
* ``moderate_system_benchmark`` — ``SystemScaler``-configured molecules
* ``skqd_lattice_validation``   — TFIM / Heisenberg SKQD, pipeline, SCI
                                  and exact full-space runs
* ``skqd_validation``           — the seven SKQD experiments
* ``skqd_necessity_test``       — is SKQD necessary, helpful or redundant
* ``graft_entry``               — ``entry()``: the stage-1 step on the
                                  10:7 synthetic system

Every function takes ``device`` and every CLI ``--device`` (default
``cuda``), the only flag the port adds.  ``cuda`` without a card raises:
nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse

import torch

__all__ = ["resolve_device", "add_device_flag"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is false: there is no CUDA card; pass --device cpu "
            "(device='cpu') to run on the CPU")
    return dev


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; "
                             "'cpu' runs every kernel's plain version)")
