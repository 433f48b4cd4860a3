"""CCSD and CCSD(T) of a registered system, on the host.

    python -m flow_guided_krylov_torch.tools.ccsd_bar \
        [--system ozone_ccpvdz_full] [--triples] [--device cuda]

Counterpart of ``tools/ccsd_bar.py``: the beyond-FCI error bar of a
frontier system from ``chem/ccsd.py::run_ccsd``, printed as one JSON line
with the JAX tool's keys (``ccsd_t_energy`` and ``triples_corr`` when the
triples ran: by default while the (T) amplitudes take under 8 GB, or with
``--triples``).  The system is a registered large system
(``examples/large_system_benchmark``) or a benchmark molecule; ``--device``
places its Hamiltonian, and the coupled-cluster iterations run in NumPy on
the host, so the tool can run beside a solver on the card.  ``wall_s`` is
the host's wall clock.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

from . import system

__all__ = ["ccsd_bar", "main"]


def ccsd_bar(name: str, device, triples: bool = False,
             verbose: bool = False) -> Dict:
    """The JAX tool's JSON fields for system ``name``."""
    from ..chem.ccsd import run_ccsd
    ints = system(name, device).integrals
    no = ints.n_electrons
    nv = 2 * ints.n_orbitals - no
    do_t = triples or (no ** 3 * nv ** 3 * 8 < 8e9)
    t0 = time.time()
    cc = run_ccsd(ints, do_triples=do_t, verbose=verbose)
    out = {"system": name, "n_active_orbitals": ints.n_orbitals,
           "n_active_electrons": no,
           "ccsd_energy": cc.e_tot, "ccsd_corr": cc.e_corr,
           "ccsd_converged": bool(cc.converged),
           "hf_energy": ints.hf_energy,
           "wall_s": round(time.time() - t0, 1)}
    if cc.e_triples is not None:
        out["ccsd_t_energy"] = cc.e_tot_t
        out["triples_corr"] = cc.e_triples
    return out


def main(argv: Optional[list] = None) -> Dict:
    """The CLI; prints the JSON line and returns it as a dict."""
    from ..examples import resolve_device
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--system", default="ozone_ccpvdz_full")
    p.add_argument("--triples", action="store_true",
                   help="force (T) even past the default memory gate")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = ccsd_bar(args.system, resolve_device(args.device), args.triples,
                   verbose=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
