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
ratio, accumulated count].

``dryrun_multichip(n)`` is the counterpart of the JAX entry's dry run
over n virtual devices: one stage-1 step of the trainer sharded over an
n-entry mesh on tiny shapes, then the four-stage pipeline with and
without the mesh, whose final energies must agree within 1e-4 Ha.  On
``cuda`` the n entries go round the host's cards (``cuda:0`` n times on
one card: a logical mesh); on ``cpu`` they are n ``cpu`` entries.

Usage: python -m flow_guided_krylov_torch.examples.graft_entry [--device cpu]
       python -m flow_guided_krylov_torch.examples.graft_entry dryrun 4
"""

import argparse
import json

import numpy as np
import torch

from ..flows import (ParticleConservingFlow, PhysicsGuidedConfig,
                     PhysicsGuidedFlowTrainer)
from ..hamiltonians.molecular import create_synthetic_hamiltonian
from ..models import DenseNQS
from ..parallel import make_mesh
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


def dryrun_mesh(n_devices: int, device="cuda"):
    """An n-entry mesh on ``device``'s kind: round the host's cards for
    ``cuda``, n ``cpu`` entries for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        k = torch.cuda.device_count()
        devices = [torch.device("cuda", i % k) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    return make_mesh(n_devices, devices=devices)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded stage-1 step over an n-entry mesh, then the pipeline's
    parity: the final energy with the mesh within 1e-4 Ha of the one
    without.  Prints both lines and returns their numbers."""
    from ..pipeline import FlowGuidedKrylovPipeline, PipelineConfig
    mesh = dryrun_mesh(n_devices, device)
    dev = mesh.first
    h = create_synthetic_hamiltonian(6, 2, 2, dev)     # tiny shapes
    flow = ParticleConservingFlow(n_orbitals=6, n_alpha=2, n_beta=2,
                                  hidden_dims=(32, 32))
    nqs = DenseNQS(num_sites=12, hidden_dims=(32, 32))
    batch = max(64, 8 * n_devices)
    trainer = PhysicsGuidedFlowTrainer(
        h, flow, nqs, PhysicsGuidedConfig(samples_per_batch=batch,
                                          verbose=False), mesh=mesh)
    vec = trainer.step(1.0).cpu().numpy()
    if not np.isfinite(vec[0]):
        raise RuntimeError(f"dryrun_multichip: non-finite step {vec}")
    print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} "
          f"devices={[str(d) for d in mesh.devices]} "
          f"E={float(vec[0]):.6f} unique_ratio={float(vec[4]):.2f} OK")

    h_pipe = create_synthetic_hamiltonian(6, 2, 2, dev, seed=3)  # 225 dets
    exact = h_pipe.fci_energy()

    def run_pipe(m):
        cfg = PipelineConfig(max_epochs=20, min_epochs=8,
                             samples_per_batch=64,
                             nf_hidden_dims=[32, 32],
                             nqs_hidden_dims=[32, 32],
                             residual_iterations=2, max_krylov_dim=3,
                             shots_per_krylov=2000, seed=4, verbose=False)
        pipe = FlowGuidedKrylovPipeline(h_pipe, cfg, exact_energy=exact)
        pipe.mesh = m
        return pipe.run()

    e_single = run_pipe(None)["final_energy"]
    e_mesh = run_pipe(mesh)["final_energy"]
    diff = abs(e_mesh - e_single)
    if not diff < 1e-4:
        raise RuntimeError(f"dryrun_multichip: E_mesh {e_mesh} against "
                           f"E_single {e_single}")
    print(f"dryrun_multichip({n_devices}): pipeline parity OK "
          f"E_mesh={e_mesh:.6f} E_single={e_single:.6f} "
          f"err_vs_exact={1000 * (e_mesh - exact):+.4f} mHa")
    return {"step_energy": float(vec[0]), "unique_ratio": float(vec[4]),
            "e_mesh": float(e_mesh), "e_single": float(e_single),
            "exact": float(exact), "mesh_shape": dict(mesh.shape)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", nargs="?", choices=["dryrun"],
                   help="dryrun N: dryrun_multichip(N)")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    add_device_flag(p)
    args = p.parse_args(argv)
    if args.command == "dryrun":
        dryrun_multichip(args.n_devices, args.device)
        return
    fn, example_args = entry(args.device)
    metrics = fn(*example_args).tolist()
    print(json.dumps(dict(zip(METRICS, metrics))))


if __name__ == "__main__":
    main()
