"""Scaling of the sharded paths of ``parallel/`` over meshes of 1, 2 and 4
entries, on the card.

    python -m flow_guided_krylov_torch.tools.sharded_scaling \\
        [--sites 24] [--molecule n2] [--device cuda]

Counterpart of ``tools/sharded_scaling.py``.  For each entry count it
times, with CUDA events:

* the sharded Trotter evolve: ``SampleBasedKrylovDiagonalization.
  _evolve_trotter`` on the periodic TFIM chain (h = 0.5) of ``--sites``
  spins, its statevector one block an entry (``parallel/
  sharded_trotter.py``);
* the sharded matvec: the ELL product of ``--molecule``'s full space
  (``SampleBasedKrylovDiagonalization._ell_matvec``; row blocks built on
  their entries, ``parallel/sharded_matvec.py::ShardedEll``), B = 2.

One entry is the unsharded path.  A logical mesh repeats the first
device (the cost of sharding alone); where the host has that many cards,
a second row spreads the entries over ``cuda:0..``.  Each sharded result
is held to the unsharded one: the evolve to ``EVOLVE_ATOL``, as
``chip_smoke.py``'s ``phase_mesh`` holds it (the mesh rotates every X at
half angle forward then reversed, the single card each commuting X once
at its full angle: one product in exact arithmetic, rounded apart in
float32); each row block's elements and targets bit for
bit to the whole table's; the product to ``MATVEC_RTOL`` of its largest
entry, since each block computes its own float32 diagonal
(``ops/slater.diagonal_batch``, a matrix product whose rounding on the
card may depend on the row count; ``diag_max_abs_diff``).  One table is
printed.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from . import card, time_ms

__all__ = ["ENTRIES", "meshes", "scaling", "main"]

ENTRIES = (1, 2, 4)
MATVEC_RTOL = 1e-6       # sharded against unsharded product, of its max
EVOLVE_ATOL = 1e-5       # sharded against unsharded evolve, per amplitude


def meshes(device, entries=ENTRIES) -> List[Dict]:
    """[{entries, layout, mesh}]: a logical mesh on ``device`` for each
    entry count (None for one entry), and on distinct cards where the host
    has that many."""
    from ..parallel import make_mesh
    device = torch.device(device)
    out = []
    for k in entries:
        if k == 1:
            out.append({"entries": 1, "layout": str(device), "mesh": None})
            continue
        out.append({"entries": k, "layout": f"{k} x {device}",
                    "mesh": make_mesh(k, basis_parallel=k,
                                      devices=[device] * k)})
        if device.type == "cuda" and torch.cuda.device_count() >= k:
            out.append({"entries": k, "layout": f"cuda:0..{k - 1}",
                        "mesh": make_mesh(k, basis_parallel=k)})
    return out


def scaling(device, sites: int = 24, molecule: str = "n2",
            reps: int = 5, entries=ENTRIES) -> List[Dict]:
    """One row a mesh of each of ``entries`` (the first must be 1, the
    unsharded yardstick): evolve and matvec ms (None off the card) and
    the gaps to the unsharded results."""
    from ..hamiltonians import MOLECULE_FACTORIES, TransverseFieldIsing
    from ..krylov import SKQDConfig, SampleBasedKrylovDiagonalization
    from ..parallel.sharded_trotter import (gather_statevector,
                                            shard_statevector)
    device = torch.device(device)
    ham = TransverseFieldIsing(sites, V=1.0, h=0.5, periodic=True,
                               device=device)
    mol = MOLECULE_FACTORIES[molecule](device)
    tcfg = SKQDConfig(evolution="trotter")
    init = np.array([0], np.uint32)
    re = torch.zeros(1 << sites, device=device)
    re[0] = 1.0
    im = torch.zeros_like(re)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, ref = [], {}
    for m in meshes(device, entries):
        mesh = m["mesh"]
        sk = SampleBasedKrylovDiagonalization(ham, tcfg, initial_state=init,
                                              mesh=mesh)
        if mesh is None:
            def evolve():
                return sk._evolve_trotter(re, im)
        else:
            blocks = shard_statevector(mesh, re, im)

            def evolve():
                return sk._evolve_trotter(*blocks)
        out = evolve()
        if mesh is not None:
            out = gather_statevector(mesh, *out)
        evolve_ms = time_ms(evolve, device, reps=reps)
        ell = SampleBasedKrylovDiagonalization(mol, SKQDConfig(
            evolution="ell"), mesh=mesh)
        mv = ell._ell_matvec()
        if "psi" not in ref:
            ref["psi"] = torch.randn((2, ell.dim), generator=gen,
                                     device=device)
        prod = mv(ref["psi"])
        matvec_ms = time_ms(lambda: mv(ref["psi"]), device, reps=reps,
                            inner=10)
        if mesh is None:
            ref["evolve"], ref["prod"] = out, prod
            ref["tables"] = ell._ell_structure()
        evolve_gap = max(float((a - b).abs().max())
                         for a, b in zip(out, ref["evolve"]))
        matvec_rel_gap = float((prod - ref["prod"]).abs().max()
                           / ref["prod"].abs().max())
        # a row block's elements and targets equal the whole table's
        # slices; its diagonal may round otherwise
        diag_gap, tables_equal = 0.0, True
        if mesh is not None:
            d0, e0, t0 = ref["tables"]
            for row0, d, e, t in ell._ell_structure().blocks:
                r = min(d.shape[0], ell.dim - row0)
                diag_gap = max(diag_gap, float(
                    (d[:r].cpu() - d0[row0:row0 + r].cpu()).abs().max()))
                tables_equal &= (torch.equal(e[:, :r].cpu(),
                                             e0[:, row0:row0 + r].cpu())
                                 and torch.equal(t[:, :r].cpu(),
                                                 t0[:, row0:row0 + r].cpu()))
        if (evolve_gap > EVOLVE_ATOL or matvec_rel_gap > MATVEC_RTOL
                or not tables_equal):
            raise RuntimeError(f"{m['layout']}: sharded against unsharded "
                               f"evolve {evolve_gap}, matvec "
                               f"{matvec_rel_gap}, tables {tables_equal}")
        rows.append({"entries": m["entries"], "layout": m["layout"],
                     "sites": sites, "trotter_evolve_ms": evolve_ms,
                     "molecule": molecule, "ell_rows": ell.dim,
                     "ell_matvec_ms": matvec_ms,
                     "evolve_gap": evolve_gap,
                     "matvec_rel_gap": matvec_rel_gap,
                     "diag_max_abs_diff": diag_gap})
        del sk, ell, mv
    base = rows[0]
    for r in rows:
        for key in ("trotter_evolve_ms", "ell_matvec_ms"):
            r[key + "_vs_1"] = (None if r[key] is None or base[key] is None
                                else r[key] / base[key])
    return rows


def main(argv: Optional[list] = None) -> List[Dict]:
    """The CLI; prints the rows and the table, and returns the rows."""
    from ..examples import resolve_device
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sites", type=int, default=24)
    p.add_argument("--molecule", default="n2")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(card(device) or f"device: {device} (no card: no time is taken)")
    rows = scaling(device, args.sites, args.molecule, args.reps)
    for r in rows:
        print("sharded scaling: " + json.dumps(r))
    print("\n| entries | layout | Trotter evolve (ms) | x vs 1 | ELL matvec "
          "(ms) | x vs 1 |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['entries']} | {r['layout']} | "
              f"{r['trotter_evolve_ms']} | {r['trotter_evolve_ms_vs_1']} | "
              f"{r['ell_matvec_ms']} | {r['ell_matvec_ms_vs_1']} |")
    return rows


if __name__ == "__main__":
    main()
