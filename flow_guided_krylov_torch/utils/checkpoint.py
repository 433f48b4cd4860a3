"""Checkpoints and stage resume on ``torch.save``.

Counterpart of ``flow_guided_krylov_tpu/utils/checkpoint.py``.  A
checkpoint is a directory holding ``state.pt`` (``torch.save`` of a tree
of tensors and plain containers, read back with
``torch.load(weights_only=True)``, so loading runs no pickled code) and a
``FORMAT`` file with the port's tag.  NumPy arrays are stored as tensors
(uint32 widened to int64) and come back as tensors.

A directory written by the JAX package (``FORMAT`` ``orbax`` or
``pickle``) is refused with :class:`CheckpointFormatError`, not read.

:class:`CheckpointManager` is the pipeline's stage-boundary store:
``save_stage`` / ``load_stage`` for stage results, and ``save_trainer`` /
``restore_trainer`` for a ``PhysicsGuidedFlowTrainer`` or a
``SpinFlowTrainer`` (both networks,
both optimizer states, the accumulated basis and its device keys, the
sampling generator's state, history and the energy EMA).  As in the JAX
package, ``save_trainer`` reads attributes only that trainer has: a
``FlowNQSTrainer`` raises ``AttributeError`` there.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "CheckpointFormatError", "FORMAT_TAG"]

FORMAT_TAG = "torch-fgk-1"
_STATE = "state.pt"
_FORMAT = "FORMAT"


class CheckpointFormatError(ValueError):
    """A checkpoint directory this package did not write."""


def _savable(x: Any) -> Any:
    """A tree of tensors, NumPy arrays, scalars and containers -> one of
    CPU tensors, Python scalars and containers."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _savable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_savable(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Write ``state`` into the directory ``path`` (made if missing);
    returns ``path``."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE + ".tmp")
    torch.save(_savable(dict(state)), tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    with open(os.path.join(path, _FORMAT), "w") as f:
        f.write(FORMAT_TAG)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The state a :func:`save_checkpoint` wrote into ``path``, on the
    CPU."""
    fmt_file = os.path.join(path, _FORMAT)
    fmt = (open(fmt_file).read().strip() if os.path.exists(fmt_file)
           else None)
    if fmt != FORMAT_TAG:
        origin = ("written by the JAX package"
                  if fmt in ("orbax", "pickle") else "not a checkpoint of "
                  "this package")
        raise CheckpointFormatError(
            f"{path}: FORMAT {fmt!r} ({origin}); the port reads only its "
            f"own {FORMAT_TAG!r} checkpoints")
    return torch.load(os.path.join(path, _STATE), map_location="cpu",
                      weights_only=True)


class CheckpointManager:
    """Stage-boundary checkpoints under one directory, one subdirectory a
    tag."""

    def __init__(self, directory: str, keep: int = 3):
        # ``keep`` is the JAX signature's; neither package prunes old tags
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path_for(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def save_stage(self, tag: str, state: Dict[str, Any]) -> str:
        return save_checkpoint(self.path_for(tag), state)

    def load_stage(self, tag: str) -> Optional[Dict[str, Any]]:
        p = self.path_for(tag)
        if not os.path.exists(p):
            return None
        return load_checkpoint(p)

    def has_stage(self, tag: str) -> bool:
        return os.path.exists(self.path_for(tag))

    def save_trainer(self, tag: str, trainer) -> str:
        """Checkpoint a ``PhysicsGuidedFlowTrainer`` or a
        ``SpinFlowTrainer``."""
        state = {
            "flow_params": trainer.flow.state_dict(),
            "nqs_params": trainer.nqs.state_dict(),
            "flow_opt_state": trainer.flow_opt.state_dict(),
            "nqs_opt_state": trainer.nqs_opt.state_dict(),
            "accumulated_basis": trainer.accumulated_basis,
            "acc_keys": trainer._acc_keys,
            "rng_state": trainer.generator.get_state(),
            "history": {k: list(v) for k, v in trainer.history.items()
                        if len(v)},
            "energy_ema": trainer.energy_ema,
        }
        return self.save_stage(tag, state)

    def restore_trainer(self, tag: str, trainer) -> bool:
        """Load a ``save_trainer`` checkpoint into ``trainer`` (built with
        the same widths on the same kind of device); False when the tag
        has none."""
        state = self.load_stage(tag)
        if state is None:
            return False
        trainer.flow.load_state_dict(state["flow_params"])
        trainer.nqs.load_state_dict(state["nqs_params"])
        trainer.flow_opt.load_state_dict(state["flow_opt_state"])
        trainer.nqs_opt.load_state_dict(state["nqs_opt_state"])
        basis = state["accumulated_basis"]
        trainer.accumulated_basis = (None if basis is None else
                                     basis.numpy().astype(np.uint32))
        # the molecular trainer's basis setter rebuilds its device keys;
        # the spin trainer keeps host keys beside its basis
        if not isinstance(trainer._acc_keys, torch.Tensor):
            keys = state.get("acc_keys")
            trainer._acc_keys = None if keys is None else keys.numpy()
        trainer.generator.set_state(state["rng_state"])
        if state.get("energy_ema") is not None:
            trainer.energy_ema = float(state["energy_ema"])
        for k, v in state.get("history", {}).items():
            trainer.history[k] = list(v)
        return True
