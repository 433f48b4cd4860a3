"""One production-scale PT2 scoring block on the card, and the device
block against the host path over source sizes.

    python -m flow_guided_krylov_torch.tools.repro_pt2_block \\
        [--system n2_ccpvdz] [--rows 32768] [--sweep] [--device cuda]

Counterpart of ``tools/repro_pt2_block.py``.  :func:`run_block` feeds
``rows`` sources to ``SelectedCIExpander._pt2_topk_device`` (connections,
one int64 key each, a stable sort, the per-key coupling sum and the exact
top K) and times its first and steady calls; at N2/cc-pVDZ (10e, 14o;
C = 2,835) 32,768 rows are 92.9 M connection elements.  The sources are
distinct random determinants with random normalized coefficients, from
``--seed`` (the JAX tool repeated HF: every connection then shares 2,835
keys, which a sort of distinct keys does not see).

:func:`sweep` (``--sweep``) scores the same kind of sources at 256,
1,024, 4,096, 16,384 and 32,768 rows through ``_pt2_candidates``, once
with device scoring and once with the host path (``use_device_scoring``
True and False: the two branches that ``DEVICE_SCORING_MIN_ELEMS``
chooses between, each with its shared tail of the externality filter and
the host diagonal), checks that their top candidates agree, and prints
each size's element count and the first size at which the device wins;
the host branch stops after two device wins in a row.
``DEVICE_SCORING_MIN_ELEMS`` is read, not changed.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import card, random_determinants, system, time_ms

__all__ = ["SWEEP_ROWS", "expander", "sources", "run_block", "sweep",
           "main"]

SWEEP_ROWS = (256, 1024, 4096, 16384, 32768)


def expander(h, use_device_scoring: Optional[bool] = None):
    """The expander the JAX tool builds: one round of 600, threshold 1e-4,
    at most 50,000 determinants; every source scored (no coefficient or
    source screen)."""
    from ..krylov import ResidualExpansionConfig, SelectedCIExpander
    cfg = ResidualExpansionConfig(
        max_iterations=1, configs_per_iteration=600,
        residual_threshold=1e-4, coefficient_threshold=0.0,
        source_screen=0.0, max_basis_size=min(h.n_valid_configs, 50_000))
    return SelectedCIExpander(h, cfg, use_device_scoring=use_device_scoring)


def sources(h, rows: int, seed: int = 0):
    """(rows distinct random determinants, their normalized random
    coefficients)."""
    src = random_determinants(h, rows, seed)
    c = np.random.default_rng(seed + 1).normal(size=rows)
    return src, c / np.linalg.norm(c)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_block(h, rows: int, iters: int = 3, seed: int = 0) -> Dict:
    """One scoring block of ``rows`` sources: its result (host candidates
    (K', W) uint32, couplings (K',) float64), the first call's wall
    (allocations and the library's first-use costs included) and the
    steady ms a block (CUDA events; None off the card)."""
    ex = expander(h)
    src, src_c = sources(h, rows, seed)
    t0 = time.perf_counter()
    cand, coup = ex._pt2_topk_device(src, src_c)
    _sync(h.device)
    first_s = time.perf_counter() - t0
    ms = time_ms(lambda: ex._pt2_topk_device(src, src_c), h.device,
                 reps=iters)
    elems = rows * h.n_connections
    return {"cand": cand, "coupling": coup, "rows": rows,
            "connections": h.n_connections, "elements": elems,
            "first_call_s": first_s if ms is not None else None,
            "ms": ms,
            "elements_per_s": None if ms is None else elems / (ms * 1e-3),
            "candidates": int(len(cand))}


def sweep(h, rows_list=SWEEP_ROWS, reps: int = 3, seed: int = 0
          ) -> List[Dict]:
    """Per source size: elements, the device branch's and the host
    branch's ms of ``_pt2_candidates`` (host clock after a synchronize,
    median of ``reps`` warm calls; None off the card) and whether the
    device won; raises if the two branches' top candidates differ.  Once
    the device has won at two sizes in a row, the host branch is no longer
    run (its time only grows with the elements, and the crossover is
    found)."""
    dev_ex, host_ex = expander(h, True), expander(h, False)
    energy = float(h.diagonal_np(h.get_hf_state()[None, :])[0])
    on_card = torch.device(h.device).type == "cuda"

    def timed(ex, src, c):
        ex._pt2_candidates(src, c, energy)                   # warm
        _sync(h.device)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            cand, scores = ex._pt2_candidates(src, c, energy)
            _sync(h.device)
            ts.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ts)), cand, scores

    out, wins_in_a_row = [], 0
    for rows in rows_list:
        src, c = sources(h, rows, seed)
        d_ms, d_cand, d_sc = timed(dev_ex, src, c)
        row = {"rows": rows, "elements": rows * h.n_connections,
               "device_ms": d_ms if on_card else None, "host_ms": None,
               "device_wins": None, "top_overlap": None}
        if wins_in_a_row < 2:
            h_ms, h_cand, h_sc = timed(host_ex, src, c)
            top = min(600, len(h_sc))
            d_top = set(h.keys(d_cand[np.argsort(-d_sc, kind="stable")
                                      [:top]]))
            h_top = set(h.keys(h_cand[np.argsort(-h_sc, kind="stable")
                                      [:top]]))
            row["top_overlap"] = len(d_top & h_top) / max(top, 1)
            if row["top_overlap"] < 0.99:
                raise RuntimeError(f"{rows} rows: device and host top {top}"
                                   f" share {row['top_overlap']:.4f}")
            if on_card:
                row["host_ms"] = h_ms
                row["device_wins"] = d_ms < h_ms
                wins_in_a_row = wins_in_a_row + 1 if d_ms < h_ms else 0
        out.append(row)
    return out


def main(argv: Optional[list] = None) -> Dict:
    """The CLI; prints, and returns {"block": run_block without its
    arrays, "sweep": rows or None, "crossover": ... or None}."""
    from ..examples import resolve_device
    from ..krylov import SelectedCIExpander
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--system", default="n2_ccpvdz")
    p.add_argument("--rows", type=int, default=32768)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--sweep", action="store_true",
                   help="the device block against the host path")
    p.add_argument("--sweep-rows", default=",".join(map(str, SWEEP_ROWS)),
                   help="source sizes of --sweep (comma-separated)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(card(device) or f"device: {device} (no card: no time is taken)")
    h = system(args.system, device)
    r = run_block(h, args.rows, args.iters, args.seed)
    del r["cand"], r["coupling"]
    block = {"system": args.system, "n_orb": h.n_orbitals, **r}
    print("pt2 block: " + json.dumps(block))
    out = {"block": block, "sweep": None, "crossover": None}
    if args.sweep:
        rows = sweep(h, [int(x) for x in args.sweep_rows.split(",")],
                     reps=args.iters, seed=args.seed)
        for row in rows:
            print("pt2 sweep: " + json.dumps(row))
        wins = [row for row in rows if row["device_wins"]]
        out["sweep"] = rows
        out["crossover"] = {
            "system": args.system,
            "first_device_win_rows": wins[0]["rows"] if wins else None,
            "first_device_win_elements": (wins[0]["elements"] if wins
                                          else None),
            "DEVICE_SCORING_MIN_ELEMS":
                SelectedCIExpander.DEVICE_SCORING_MIN_ELEMS}
        print("pt2 crossover: " + json.dumps(out["crossover"]))
    return out


if __name__ == "__main__":
    main()
