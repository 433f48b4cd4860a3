"""Main molecular benchmark CLI.

Counterpart of the JAX package's ``examples/benchmark.py``: per-molecule
pipeline runs with chemical-accuracy PASS/FAIL and a summary table.

Usage:
    python -m flow_guided_krylov_torch.examples.benchmark --molecule h2
    python -m flow_guided_krylov_torch.examples.benchmark --molecule all --quick
    python -m flow_guided_krylov_torch.examples.benchmark --molecule all --pt2-only
    python -m flow_guided_krylov_torch.examples.benchmark --molecule lih --nf-only --device cpu
"""

import argparse
import json
import sys
import time

from ..hamiltonians import MOLECULE_FACTORIES
from ..krylov import ResidualExpansionConfig, iterative_residual_expansion
from ..pipeline import PipelineConfig, run_molecular_benchmark
from . import add_device_flag, resolve_device

MOLECULES = {
    # name: (qubits, n_valid, description)
    "h2": (4, 4, "hydrogen, trivial sanity check"),
    "lih": (12, 225, "lithium hydride"),
    "h2o": (14, 441, "water"),
    "beh2": (14, 1225, "beryllium hydride"),
    "nh3": (16, 3136, "ammonia"),
    "n2": (20, 14400, "nitrogen, strongly correlated"),
    "ch4": (18, 15876, "methane"),
}

CHEMICAL_ACCURACY_MHA = 1.6


def quick_config(quick: bool, nf_only: bool):
    cfg = PipelineConfig()
    if quick:
        cfg.max_epochs = 150
        cfg.min_epochs = 50
        cfg.samples_per_batch = 1024
        cfg.nqs_hidden_dims = [256, 256, 256]
        cfg.nf_hidden_dims = [128, 128]
        cfg.max_krylov_dim = 4
        cfg.shots_per_krylov = 20000
    if nf_only:
        cfg.skip_skqd = True
        cfg.use_residual_expansion = False
    return cfg


def benchmark_molecule(name: str, quick: bool, nf_only: bool,
                       pt2_only: bool = False,
                       verbose: bool = True, device="cuda") -> dict:
    device = resolve_device(device)
    t0 = time.perf_counter()
    if pt2_only:
        out = pt2_only_run(name, device=device)
    else:
        cfg = quick_config(quick, nf_only)
        cfg.verbose = verbose
        out = run_molecular_benchmark(name, cfg, device=device)
    out["total_time"] = time.perf_counter() - t0
    return out


def pt2_only_run(name: str, device="cuda") -> dict:
    """HF-seeded iterative Selected-CI (no flow): composes the framework's
    stage-3 machinery alone — the fastest route for small/medium systems."""
    h = MOLECULE_FACTORIES[name](resolve_device(device))
    exact = h.fci_energy()
    cfg = ResidualExpansionConfig(max_iterations=40,
                                  configs_per_iteration=300,
                                  stagnation_threshold=1e-6,
                                  stagnation_patience=3,
                                  max_basis_size=min(h.n_valid_configs,
                                                     30_000))
    out = iterative_residual_expansion(h, h.get_hf_state()[None, :], cfg)
    e = out["energy"]
    return {"molecule": name, "final_energy": float(e),
            "exact_energy": float(exact),
            "error_mha": 1000 * (e - exact),
            "chemical_accuracy": abs(e - exact) < 1.6e-3,
            "nf_basis_size": int(len(out["basis"]))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--molecule", default="h2",
                   help=f"one of {sorted(MOLECULES)} or 'all'")
    p.add_argument("--quick", action="store_true",
                   help="smaller nets / fewer epochs")
    p.add_argument("--nf-only", action="store_true",
                   help="skip residual expansion and SKQD (NF-only mode)")
    p.add_argument("--pt2-only", action="store_true",
                   help="HF-seeded Selected-CI only (no flow training): the "
                        "fastest route to chemical accuracy on small/medium "
                        "systems")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per molecule")
    p.add_argument("--quiet", action="store_true")
    add_device_flag(p)
    args = p.parse_args(argv)

    names = (sorted(MOLECULES) if args.molecule == "all"
             else [args.molecule.lower()])
    rows = []
    for name in names:
        if name not in MOLECULES:
            print(f"unknown molecule {name!r}; choose from "
                  f"{sorted(MOLECULES)} or 'all'", file=sys.stderr)
            sys.exit(2)
        print(f"\n### {name.upper()} "
              f"({MOLECULES[name][0]} qubits, "
              f"{MOLECULES[name][1]:,} valid configs) ###")
        out = benchmark_molecule(name, args.quick, args.nf_only,
                                 pt2_only=args.pt2_only,
                                 verbose=not args.quiet, device=args.device)
        rows.append(out)
        if args.json:
            keep = {k: out[k] for k in
                    ("molecule", "final_energy", "exact_energy", "error_mha",
                     "chemical_accuracy", "nf_basis_size", "total_time")
                    if k in out}
            print(json.dumps(keep))
    print_summary(rows)
    n_pass = sum(bool(out.get("chemical_accuracy")) for out in rows)
    sys.exit(0 if n_pass == len(rows) else 1)


def print_summary(rows) -> None:
    """Side-by-side NF-only vs NF+Krylov per molecule; the NF-only column
    comes from the same run's stage-2 energy."""
    print("\n" + "=" * 86)
    print(f"{'molecule':<10}{'E_final':>14}{'E_FCI':>14}"
          f"{'NF-only (mHa)':>15}{'NF+Krylov (mHa)':>17}"
          f"{'status':>7}{'time (s)':>9}")
    print("-" * 86)
    n_pass = 0
    for out in rows:
        status = "PASS" if out.get("chemical_accuracy") else "FAIL"
        n_pass += status == "PASS"
        exact = out.get("exact_energy")
        nf_err = (1000 * (out["nf_energy"] - exact)
                  if exact is not None and "nf_energy" in out
                  else float("nan"))
        print(f"{out['molecule']:<10}{out['final_energy']:>14.6f}"
              f"{exact if exact is not None else float('nan'):>14.6f}"
              f"{nf_err:>15.4f}"
              f"{out.get('error_mha', float('nan')):>17.4f}"
              f"{status:>7}{out['total_time']:>9.1f}")
    print("=" * 86)
    print(f"{n_pass}/{len(rows)} within chemical accuracy "
          f"({CHEMICAL_ACCURACY_MHA} mHa)")


if __name__ == "__main__":
    main()
