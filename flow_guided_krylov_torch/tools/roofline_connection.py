"""Roofline and attribution of the Slater-Condon connection function
(``ops/slater.py::make_connection_fn``) on the card.

    python -m flow_guided_krylov_torch.tools.roofline_connection \\
        [--system bench_10_7|n2_ccpvdz] [--rows N] [--measure] [--device cuda]

Counterpart of ``tools/roofline_connection.py``, with the port's own
accounting in place of the TPU's:

* **Analytic part** (:func:`analytic`): bytes and float32 operations of
  one call over ``rows`` determinants, from the tensors the port writes:
  each connection's W int64 target words and its float32 element (the
  Jordan-Wigner sign is folded into it), the packed rows read once and
  the integral tables and excitation grids read once; the operations are
  the float32 multiplies and adds of the effective single-excitation
  matrices (6n^3 + 4n^2 + n a row) and of the elements (1 a single or
  opposite-spin double, 2 a same-spin double).  Integer work (occupied
  lists, parities, bit flips, gather indices) is not counted.  The least
  time is the larger of bytes over the memory rate and operations over
  the float32 rate (``tools.bound``).
* **--measure** (:func:`measure`): the device time of one call (CUDA
  events), its kernel launches and summed kernel time (``torch.profiler``)
  and its share of the full call's time, for the production call and
  these ablations: output writes off (targets, elements, or both reduced
  to a scalar), the h2 gathers replaced by their index, the parities
  replaced by +1, the occupied / virtual lists alone, and the whole batch
  in one chunk (the production loop takes 2,048 rows a chunk: the
  dispatch cost of the chunk loop).

Systems: ``bench_10_7`` is ``examples/bench.py``'s synthetic 10-orbital
(7a, 7b) space, all 14,400 determinants (C = 609); ``n2_ccpvdz`` is
N2/cc-pVDZ's (10e, 14o) active space (C = 2,835), 32,768 random
determinants from ``--seed``.  Both take one word a spin channel
(W = 2), the width the ablations rebuild.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from . import bound, card, profile_launches, random_determinants, time_ms

__all__ = ["SYSTEMS", "analytic", "measure", "main"]


def _bench_10_7(device):
    from ..hamiltonians.molecular import create_synthetic_hamiltonian
    return create_synthetic_hamiltonian(10, 7, 7, device)


def _n2_ccpvdz(device):
    from ..examples.large_system_benchmark import n2_ccpvdz
    return n2_ccpvdz(device)


# name -> (Hamiltonian factory, default rows; 0: the whole space)
SYSTEMS = {"bench_10_7": (_bench_10_7, 0), "n2_ccpvdz": (_n2_ccpvdz, 32768)}


def analytic(h, rows: int) -> Dict:
    """Bytes, float32 operations and the least time of one connection
    call over ``rows`` determinants of ``h``."""
    t = h.tables
    n, W, C = t.n_orb, h.pack_words, t.n_connections
    sa, sb, da, db, nab = t.section_sizes()
    out_per_conn = 8 * W + 4                    # int64 targets + f32 element
    output_bytes = rows * C * out_per_conn
    tables_bytes = 4 * (n * n + 2 * n ** 3 + n ** 4) + 8 * (
        2 * (sa + sb) + 4 * (da + db) + 4 * nab)
    input_bytes = 8 * W * rows + tables_bytes
    flops_row = (6 * n ** 3 + 4 * n * n + n) + (sa + sb + 2 * (da + db)
                                                 + nab)
    flops = rows * flops_row
    bound_ms, bound_by = bound(output_bytes + input_bytes, flops)
    return {"n_orb": n, "n_alpha": t.n_alpha, "n_beta": t.n_beta,
            "W": W, "C": C,
            "sections": {"singles_a": sa, "singles_b": sb, "doubles_aa": da,
                         "doubles_bb": db, "doubles_ab": nab},
            "rows": rows, "connections": rows * C,
            "output_bytes_per_connection": out_per_conn,
            "output_bytes": output_bytes, "input_bytes": input_bytes,
            "flops": flops, "flops_per_connection": flops / (rows * C),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_connections_per_s": rows * C / (bound_ms * 1e-3)}


def _variants(h, device) -> Dict:
    """{name: f(packed (B, 2) int64)} over the whole batch: the production
    call and its ablations, each through the production chunk size."""
    from ..ops.bits import occupancy, parity_between
    from ..ops.slater import (CHUNK_ENTRIES, _chunked, _connection_sections,
                              make_connection_fn)
    t = h.tables
    n, C = t.n_orb, t.n_connections
    if h.pack_words != 2:
        raise ValueError("the ablations rebuild the one-word function "
                         "(W = 2, up to 32 orbitals)")
    chunk = max(1, min(2048, CHUNK_ENTRIES // max(C, 1)))
    orbitals = torch.arange(n, device=device)

    def sections(**hooks):
        return _connection_sections(t, device, hooks.get(
            "parity", parity_between), h2_gather=hooks.get("h2_gather"))

    def written(secs_fn):
        # make_connection_fn's block on other sections
        def block(packed):
            secs = secs_fn(packed[:, 0:1], packed[:, 1:2])
            return (torch.cat([torch.stack([a.expand_as(e), b.expand_as(e)],
                                           -1) for a, b, e in secs], 1),
                    torch.cat([e for _, _, e in secs], 1))
        return _chunked(block, 2, C, device, chunk)

    def reduced(keep_conn, keep_elems):
        # the production chunk loop with the targets and/or the elements
        # summed to a scalar in place of their write
        secs_fn = sections()

        def call(packed):
            B = packed.shape[0]
            conn = (torch.empty((B, C, 2), dtype=torch.int64, device=device)
                    if keep_conn else None)
            el = (torch.empty((B, C), dtype=torch.float32, device=device)
                  if keep_elems else None)
            total = torch.zeros((), dtype=torch.float64, device=device)
            for i in range(0, B, chunk):
                part = packed[i:i + chunk]
                secs = secs_fn(part[:, 0:1], part[:, 1:2])
                if keep_conn:
                    conn[i:i + chunk] = torch.cat(
                        [torch.stack([a.expand_as(e), b.expand_as(e)], -1)
                         for a, b, e in secs], 1)
                else:
                    total += sum(a.sum() + b.sum() for a, b, _ in secs)
                if keep_elems:
                    el[i:i + chunk] = torch.cat([e for _, _, e in secs], 1)
                else:
                    total += sum(e.sum().double() for _, _, e in secs)
            return conn, el, total
        return call

    def lists_only(packed):
        total = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(0, packed.shape[0], chunk):
            for col in (0, 1):
                occ = occupancy(packed[i:i + chunk, col], n)
                total += torch.argsort((1 - occ) * n + orbitals, dim=1).sum()
        return total

    ones = (lambda bits, p, q: torch.ones_like(p))   # noqa: E731
    index = (lambda h2f, i: i.to(h2f.dtype))         # noqa: E731
    return {
        "full": make_connection_fn(t, device),
        "one_chunk": make_connection_fn(t, device, chunk=1 << 30),
        "no_elem_write": reduced(keep_conn=True, keep_elems=False),
        "no_conn_write": reduced(keep_conn=False, keep_elems=True),
        "scalar_out": reduced(keep_conn=False, keep_elems=False),
        "no_h2_gather": written(sections(h2_gather=index)),
        "no_parity": written(sections(parity=ones)),
        "lists_only": lists_only,
    }, chunk


def measure(h, packed: np.ndarray, device, reps: int = 5) -> Dict:
    """Per variant: ms of one call (CUDA events; None off the card), its
    launches and summed kernel ms (``torch.profiler``), its share of the
    full call's ms and its connection rate."""
    from ..ops.bits import to_device
    device = torch.device(device)
    batch = to_device(packed, device)
    variants, chunk = _variants(h, device)
    total = len(packed) * h.n_connections
    rows = {}
    for name, fn in variants.items():
        ms = time_ms(lambda: fn(batch), device, reps=reps)
        launches, kernel_ms = profile_launches(lambda: fn(batch), device)
        rows[name] = {"ms": ms, "launches": launches, "kernel_ms": kernel_ms,
                      "connections_per_s": (None if ms is None
                                            else total / (ms * 1e-3))}
    full = rows["full"]["ms"]
    for r in rows.values():
        r["share_of_full"] = (None if full is None or r["ms"] is None
                              else r["ms"] / full)
    return {"rows": len(packed), "chunk_rows": chunk,
            "chunks": -(-len(packed) // chunk), "variants": rows}


def main(argv: Optional[list] = None) -> Dict:
    """The CLI; prints, and returns {"roofline": analytic, "measured":
    measure or None}."""
    from ..examples import resolve_device
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--system", default="bench_10_7", choices=sorted(SYSTEMS))
    p.add_argument("--rows", type=int, default=None,
                   help="determinants a call (default: the system's)")
    p.add_argument("--measure", action="store_true",
                   help="time the production call and its ablations")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(card(device) or f"device: {device} (no card: no time is taken)")
    factory, default_rows = SYSTEMS[args.system]
    h = factory(device)
    rows = default_rows if args.rows is None else args.rows
    if rows:
        packed = random_determinants(h, rows, args.seed)
    else:
        basis = h.enumerate_basis()
        packed = basis[np.random.default_rng(args.seed).permutation(
            len(basis))]
    out = {"system": args.system, **analytic(h, len(packed))}
    print("roofline: " + json.dumps(out))
    m = None
    if args.measure:
        m = measure(h, packed, device, args.reps)
        for name, r in m["variants"].items():
            print(f"roofline variant {name}: " + json.dumps(r))
        full = m["variants"]["full"]["ms"]
        m["bound_share"] = None if full is None else out["bound_ms"] / full
        print("roofline measured: " + json.dumps({
            "system": args.system, "rows": m["rows"],
            "chunk_rows": m["chunk_rows"], "chunks": m["chunks"],
            "full_ms": full, "bound_ms": out["bound_ms"],
            "bound_share": m["bound_share"]}))
    return {"roofline": out, "measured": m}


if __name__ == "__main__":
    main()
