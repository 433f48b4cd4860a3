"""Is SKQD NECESSARY, HELPFUL, or REDUNDANT per molecule?

Counterpart of the JAX package's ``examples/skqd_necessity_test.py``:
after NF training and PT2 residual expansion, run Krylov sampling and
measure the *unique* contribution of Krylov-discovered configurations via
set algebra.

Verdicts:
  REDUNDANT — Krylov finds no configs beyond NF+residual, or they do not
              change the energy (> -0.01 mHa)
  HELPFUL   — Krylov-unique configs improve the energy by < 1.6 mHa
  NECESSARY — Krylov-unique configs improve the energy by >= 1.6 mHa

Usage: python -m flow_guided_krylov_torch.examples.skqd_necessity_test --molecule lih
"""

import argparse
import json

from ..hamiltonians import MOLECULE_FACTORIES
from ..krylov import (ResidualExpansionConfig, SKQDConfig,
                      SampleBasedKrylovDiagonalization,
                      iterative_residual_expansion)
from ..pipeline import FlowGuidedKrylovPipeline, PipelineConfig
from ..postprocessing import basis_overlap, merge_bases
from . import add_device_flag, resolve_device


def necessity_test(molecule: str, residual_iters: int = 15,
                   krylov_dim: int = 12, verbose: bool = True,
                   device="cuda") -> dict:
    h = MOLECULE_FACTORIES[molecule](resolve_device(device))
    exact = h.fci_energy()

    cfg = PipelineConfig(max_epochs=200, min_epochs=60,
                         samples_per_batch=1536,
                         nqs_hidden_dims=[256, 256, 256],
                         nf_hidden_dims=[128, 128], verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=exact)
    pipe.train_flow_nqs()
    pipe.extract_and_select_basis()

    res = iterative_residual_expansion(
        h, pipe.nf_basis,
        ResidualExpansionConfig(max_iterations=residual_iters,
                                configs_per_iteration=150,
                                max_basis_size=16384))
    base_basis = res["basis"]
    e_base = res["energy"]

    skqd = SampleBasedKrylovDiagonalization(
        h, SKQDConfig(max_krylov_dim=krylov_dim, shots_per_krylov=50000))
    k_out = skqd.run()
    k_basis = k_out["bases"][-1]

    overlap = basis_overlap(base_basis, k_basis, keys_fn=h.keys)
    combined = merge_bases(base_basis, k_basis)
    e_combined = skqd.compute_ground_state_energy(combined)
    contribution_mha = 1000 * (e_base - e_combined)

    if overlap["n_b_only"] == 0 or contribution_mha < 0.01:
        verdict = "REDUNDANT"
    elif contribution_mha < 1.6:
        verdict = "HELPFUL"
    else:
        verdict = "NECESSARY"

    out = {
        "molecule": molecule,
        "n_valid": h.n_valid_configs,
        "nf_residual_mha": 1000 * (e_base - exact),
        "combined_mha": 1000 * (e_combined - exact),
        "krylov_unique_configs": overlap["n_b_only"],
        "krylov_unique_contribution_mha": contribution_mha,
        "verdict": verdict,
    }
    if verbose:
        print(json.dumps(out))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--molecule", default="lih")
    p.add_argument("--all", action="store_true",
                   help="run the scaling table h2..n2")
    add_device_flag(p)
    args = p.parse_args(argv)
    mols = (["h2", "lih", "h2o", "beh2", "nh3", "n2"] if args.all
            else [args.molecule])
    rows = [necessity_test(m, device=args.device) for m in mols]
    if len(rows) > 1:
        print(f"\n{'molecule':<8}{'valid':>8}{'K-unique':>10}"
              f"{'contrib(mHa)':>14}{'verdict':>12}")
        for r in rows:
            print(f"{r['molecule']:<8}{r['n_valid']:>8}"
                  f"{r['krylov_unique_configs']:>10}"
                  f"{r['krylov_unique_contribution_mha']:>14.3f}"
                  f"{r['verdict']:>12}")


if __name__ == "__main__":
    main()
