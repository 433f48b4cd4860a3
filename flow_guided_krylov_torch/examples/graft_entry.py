"""Compile-check entry: the flagship stage-1 step and its arguments.

Counterpart of the JAX package's ``__graft_entry__.py::entry``: returns
``(fn, example_args)``, the stage-1 training step of
``PhysicsGuidedFlowTrainer`` on an N2-sized synthetic molecular system
(10 orbitals, 7 alpha and 7 beta electrons: 20 qubits, 14,400
determinants) with the JAX entry's widths, 512 samples a step and the
on-the-fly connection function (``use_connection_table=False``).  The
port's step is eager and holds its parameters and optimizer states itself,
so its one argument is the sampling temperature: ``fn(*example_args)``
runs one epoch (flow sampling, dedup, Slater-Condon connections, NQS
local energies, both losses and the two optimizer updates) and returns
the device metrics vector [energy, teacher, physics, entropy, unique
ratio, accumulated count].  ``dryrun_multichip``
needs the multi-device code, which is not ported yet (ROADMAP.md,
Queue 1, item 3).

Usage: python -m flow_guided_krylov_torch.examples.graft_entry [--device cpu]
"""

import argparse
import json

from ..flows import (ParticleConservingFlow, PhysicsGuidedConfig,
                     PhysicsGuidedFlowTrainer)
from ..hamiltonians.molecular import create_synthetic_hamiltonian
from ..models import DenseNQS
from . import add_device_flag, resolve_device

METRICS = ("energy", "teacher_loss", "physics_loss", "entropy",
           "unique_ratio", "accumulated")


def entry(device="cuda"):
    """``(fn, example_args)``: one stage-1 step on the flagship
    (N2-sized) system on ``device``."""
    device = resolve_device(device)
    h = create_synthetic_hamiltonian(10, 7, 7, device)   # 20 qubits
    flow = ParticleConservingFlow(n_orbitals=10, n_alpha=7, n_beta=7,
                                  hidden_dims=(256, 256))
    nqs = DenseNQS(num_sites=20, hidden_dims=(256, 256, 256))
    # on-the-fly connection kernel (no precomputed table)
    cfg = PhysicsGuidedConfig(samples_per_batch=512, verbose=False,
                              use_connection_table=False)
    trainer = PhysicsGuidedFlowTrainer(h, flow, nqs, cfg)
    fn = trainer.step
    example_args = (1.0,)
    return fn, example_args


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_device_flag(p)
    args = p.parse_args(argv)
    fn, example_args = entry(args.device)
    metrics = fn(*example_args).tolist()
    print(json.dumps(dict(zip(METRICS, metrics))))


if __name__ == "__main__":
    main()
