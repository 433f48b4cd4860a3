"""Headline benchmark: batched <x|H|y> matrix-element throughput.

Counterpart of the JAX package's ``bench.py``.  For a batch of
determinants, enumerate ALL connected determinants and their
Slater-Condon matrix elements on the device: the whole N2-sized 10:7
space (20 qubits, 14,400 determinants, 609 connections each) in one
batch through the port's connection function
(``ops/slater.py::make_connection_fn``, the one every device call site
builds; the port has no kernel router), timed with the device
synchronized.

``vs_baseline`` divides that rate by the rate of ``connections_batch_np``
(the vectorized float64 NumPy host mirror) over the same batch, measured
in the same run on the same host: the median of three warm runs, which is
also ``host_rate_live``.  The JAX bench pinned its host rate as a constant
measured on its own host; the port does not carry it.

Then the wall from the HF determinant to < 1.6 mHa against FCI through
the stage-3 Selected-CI machinery on N2/STO-3G and CH4/STO-3G.

Prints ONE JSON line with the JAX bench's keys.

Usage: python -m flow_guided_krylov_torch.examples.bench [--device cpu]
"""

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..chem.scf import MolecularIntegrals
from ..hamiltonians.molecular import MOLECULE_FACTORIES, MolecularHamiltonian
from ..krylov import ResidualExpansionConfig, SelectedCIExpander
from ..ops.bits import to_device
from ..ops.slater import connections_batch_np
from . import add_device_flag, resolve_device

DEVICE_ITERS = 10      # timed calls of the connection function, after one
HOST_RUNS = 3          # timed warm runs of the host mirror (the median)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "kernel",
              "host_rate_live", "n2_time_to_chemacc_s", "n2_error_mha",
              "n2_basis_size", "ch4_time_to_chemacc_s", "ch4_error_mha",
              "ch4_basis_size")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def connection_rate(device="cuda") -> dict:
    """The connection function's rate over the whole 10:7 space (mean of
    ``DEVICE_ITERS`` warm calls) and the host mirror's (median of
    ``HOST_RUNS`` warm runs)."""
    device = resolve_device(device)
    # N2/STO-3G-sized synthetic system (20 qubits, C(10,7)^2 = 14,400 dets)
    rng = np.random.default_rng(0)
    n = 10
    h1 = rng.normal(size=(n, n))
    h1 = 0.5 * (h1 + h1.T)
    h2 = rng.normal(size=(n,) * 4) * 0.1
    h2 = h2 + h2.transpose(1, 0, 2, 3)
    h2 = h2 + h2.transpose(0, 1, 3, 2)
    h2 = h2 + h2.transpose(2, 3, 0, 1)
    ints = MolecularIntegrals(h1e=h1, h2e=h2 / 8, nuclear_repulsion=0.5,
                              n_electrons=14, n_orbitals=n,
                              n_alpha=7, n_beta=7)
    h = MolecularHamiltonian(ints, device)

    # the whole N2-sized space in one batch, in a random order
    basis = h.enumerate_basis()
    B = len(basis)
    batch = basis[rng.permutation(B)]
    C = h.n_connections

    batch_dev = to_device(batch, device)
    fn = h.connections_device
    out = fn(batch_dev)                    # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(DEVICE_ITERS):
        out = fn(batch_dev)
    _sync(device)
    dt_dev = (time.perf_counter() - t0) / DEVICE_ITERS
    del out

    connections_batch_np(batch, h.tables)  # warm
    walls = []
    for _ in range(HOST_RUNS):
        t0 = time.perf_counter()
        connections_batch_np(batch, h.tables)
        walls.append(time.perf_counter() - t0)
    return {"rate": B * C / dt_dev,
            "host_rate": B * C / statistics.median(walls),
            # the function ``make_connection_fn_auto`` picks at this width
            "kernel": "ops/slater.py::" + ("make_connection_fn_w2"
                                           if h.n_orbitals > 32
                                           else "make_connection_fn")}


def time_to_accuracy(molecule: str, device="cuda"):
    """Wall-clock from HF seed to <1.6 mHa vs FCI (N2/STO-3G: 14,400
    configs; CH4: 15,876) via the stage-3 Selected-CI machinery.  The FCI
    oracle is instrumentation (disk cached, nothing in the solver reads
    it); the timed region is the solve alone."""
    h = MOLECULE_FACTORIES[molecule](resolve_device(device))
    exact = h.fci_energy()
    cfg = ResidualExpansionConfig(
        max_iterations=40, configs_per_iteration=300,
        stagnation_threshold=1e-6, stagnation_patience=3,
        max_basis_size=min(h.n_valid_configs, 30_000))
    expander = SelectedCIExpander(h, cfg)
    basis = h.get_hf_state()[None, :]
    t0 = time.perf_counter()
    wall = None
    e = float("inf")
    for _ in range(cfg.max_iterations):
        out = expander.expand_basis(basis)
        basis, e = out["basis"], out["energy"]
        if e - exact < 1.6e-3:
            wall = round(time.perf_counter() - t0, 2)
            break
        if not out["accepted"]:
            break
    return wall, round(1000 * (e - exact), 4), int(len(basis))


def bench(device="cuda") -> dict:
    """The bench's one record (the dict ``main`` prints)."""
    rates = connection_rate(device)
    tta_s, tta_err, tta_basis = time_to_accuracy("n2", device)
    # a second wall on another shape (CH4: 15,876 configs, C = 560)
    tta2_s, tta2_err, tta2_basis = time_to_accuracy("ch4", device)
    return {
        "metric": "matrix_elements_per_second",
        "value": round(rates["rate"]),
        "unit": "elements/s",
        "vs_baseline": round(rates["rate"] / rates["host_rate"], 2),
        "kernel": rates["kernel"],
        "host_rate_live": round(rates["host_rate"]),
        "n2_time_to_chemacc_s": tta_s,
        "n2_error_mha": tta_err,
        "n2_basis_size": tta_basis,
        "ch4_time_to_chemacc_s": tta2_s,
        "ch4_error_mha": tta2_err,
        "ch4_basis_size": tta2_basis,
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    args = p.parse_args(argv)
    print(json.dumps(bench(args.device)))


if __name__ == "__main__":
    main()
