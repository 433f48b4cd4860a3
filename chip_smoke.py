#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flow_guided_krylov_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout (one ``nvcc`` per source, started together), holds each against
its plain torch version on the card, then drives the port's two slices
through their public entry points: the molecular one on N2/STO-3G (20
qubits, 14,400 determinants, 609 connections each) and the spin-lattice
one on the transverse-field Ising chain at 24 sites (a 2^24-amplitude
statevector):

1. device and toolchain report (TF32 must be off);
2. ELL SpMV kernel vs its segmented plain version (bit for bit) on two
   tables: N2's full space (14,400 x 609, psi in shared memory, and the
   L2 route beside it) and a synthetic 11-orbital (5a, 5b) space
   (213,444 x 1,260, random integrals from a seed), B = 1 and 2; each
   timed beside its memory bound and cuSPARSE's CSR product
   (``torch.sparse_csr_tensor`` times psi as a strided and as a
   contiguous (N, B) matrix, and times one vector at B = 1: a yardstick
   the port never calls);
3. x_sweep kernel vs plain version at n = 24 and 28, forward and
   reversed: contiguous tiles of 2^13 and 2^14 amplitudes (TFIM-24's low
   X words; a mixed list of X, XX, YY and a Y with a Z outside the tile)
   and gathered tiles (TFIM-24's 20 high words on bits {0..3, 14..23}; a
   mixed list whose XX and YY straddle bit 13|14), each beside its bound;
   then the sweep's parts at n = 24: a copy (no word), one, two and four
   register phases;
4. stage 3: HF-seeded Selected-CI to < 1.6 mHa against the port's own FCI
   oracle, host scoring and then forced device scoring;
5. stage 4: FlowGuidedSKQD on the stage-3 basis with ELL evolution
   through the kernel, checked against FCI, the stage-3 energy and the
   f64 scipy propagator; one dense evolve is timed beside an ELL one;
6. spin SKQD on TFIM-24 (h = 0.5, K = 10, 100k shots, ``auto`` ->
   Trotter through the x_sweep kernel, no plain rotation on the card),
   checked against the free-fermion energy, against the basis and energy
   of the earlier runs, and for bit-equal samples from a second run with
   the same seed; then one Heisenberg-hx-20 Trotter evolve on the card
   against the same evolve on the CPU, which takes the plain route.

Kernel times are medians over CUDA-event windows: ``ms`` of one launch a
window (the host's launch gap included), ``device_ms`` of launches back to
back (the card's own time).  Every phase raises on failure (non-zero
exit).  The last two lines are
one JSON object with the kernels' numbers and the result line
``{"ok": true, "device": {...}}``.  Integrals and the FCI oracle are
cached under ``.fgk_cache/`` in the checkout (``FGK_INTEGRAL_CACHE``
overrides it).  Needs no network; imports no JAX.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
FCI_N2_REF = -107.654121          # results/final_benchmark_all.txt:279
STAGE4_N2_MHA = 1.5603            # stage 4 on N2 before the segmented sum
SWEEP_TOL = 0.0                   # kernel vs plain: same rounding and order
ELL_TOL = 0.0                     # kernel vs plain: same segments and order
CSR_RTOL = 1e-5                   # cuSPARSE vs kernel: f32, another order
HEIS_EVOLVE_TOL = 0.0             # card vs CPU: same phase, same rounding
# TFIM-24, seed 0: basis size and energy error of the earlier runs; the
# host eigsh starts from a random vector, which moves the error by ~1e-10
TFIM24_BASIS, TFIM24_MHA, TFIM24_MHA_TOL = 20_325, 3.9038501075, 1e-6
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12            # float32 outside the tensor cores


def bound(nbytes, flops):
    """Least time in ms for the bytes at the memory's rate and the flops
    at the float32 rate, and which of the two sets it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _cmd(args):
    out = subprocess.run(args, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def _median_ms(fn, reps, inner=1):
    """Median over ``reps`` warm windows, each timed with CUDA events, of
    the time per call of ``inner`` back-to-back calls.  With inner = 1 the
    window holds one call and the host's launch gap before it; with more,
    the launches queue while the card works, so short kernels show their
    device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device():
    import torch
    smi = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi.splitlines()[0])
    from flow_guided_krylov_torch.utils.build import find_nvcc
    import importlib.metadata as md
    import importlib.util
    nvcc = _cmd([find_nvcc(), "--version"]).splitlines()[-1]
    triton = (md.version("triton") if importlib.util.find_spec("triton")
              else "absent")
    prec = torch.get_float32_matmul_precision()
    tool = {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc, "triton": triton,
            "ninja": shutil.which("ninja") or "absent",
            "matmul_precision": prec,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    print("toolchain: " + json.dumps(tool))
    if prec != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 matmuls must run in full precision")


def ell_tables(h):
    """(diag, elems_t, tgt_t) of the full space, built on the card."""
    from flow_guided_krylov_torch.utils.connection_table import \
        build_connection_table
    t = build_connection_table(h, max_entries=h.n_valid_configs
                               * h.n_connections)
    ell = (t.diag, t.elems.T.contiguous(), t.target_idx.T.contiguous())
    del t
    return ell


def phase_build():
    """Build every kernel of the port, one nvcc per source, together."""
    from flow_guided_krylov_torch.ops import ell_spmv as ell
    from flow_guided_krylov_torch.ops import x_sweep as xs
    from flow_guided_krylov_torch.utils.build import BUILD_DIR

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    names = ("ell_spmv", "x_sweep")
    with ThreadPoolExecutor(len(names)) as pool:
        secs = list(pool.map(timed, (ell._library, xs._library)))
    for name, sec in zip(names, secs):
        for f in os.listdir(BUILD_DIR):
            if f.startswith(name) and f.endswith(".log"):
                with open(os.path.join(BUILD_DIR, f)) as fh:
                    for line in fh.read().splitlines():
                        if "registers" in line or "spill" in line:
                            print(f"ptxas {name}: " + line.strip())
        print(f"kernel build {name}: {sec:.2f} s (nvcc, sm_90a, in parallel)")


def csr_of_ell(diag, el_t, tgt_t):
    """diag + the ELL tables as one CSR matrix (int32 indices), for
    cuSPARSE's product."""
    import torch
    c, n = el_t.shape
    cols = torch.cat([torch.arange(n, dtype=torch.int32,
                                   device=diag.device)[:, None],
                      tgt_t.T], 1).reshape(-1)
    vals = torch.cat([diag[:, None], el_t.T], 1).reshape(-1)
    crow = torch.arange(0, n + 1, dtype=torch.int32,
                        device=diag.device) * (c + 1)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta state"
        return torch.sparse_csr_tensor(crow, cols, vals, (n, n))


def library_products(csr, psi):
    """cuSPARSE's CSR product with psi: name -> (result (B, N), ms,
    device_ms).  psi.T is a strided (N, B) view; its contiguous copy is
    made before the timing; the matrix-vector form takes one row of psi a
    call, so at B = 2 it is two calls and no candidate for library_ms."""
    import torch
    psi_t = psi.T.contiguous()
    forms = {"csr @ psi.T": lambda: (csr @ psi.T).T,
             "csr @ psi.T.contiguous()": lambda: (csr @ psi_t).T,
             "csr @ psi[b], each b": lambda: [csr @ p for p in psi]}
    out = {}
    for name, fn in forms.items():
        res = fn()
        out[name] = (torch.stack(res) if isinstance(res, list) else res,
                     _median_ms(fn, 50), _median_ms(fn, 10, 20))
    return out


def phase_kernel():
    import torch
    from flow_guided_krylov_torch.hamiltonians import (
        create_n2_hamiltonian, create_synthetic_hamiltonian)
    from flow_guided_krylov_torch.ops import ell_spmv as ell

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, h in (("n2", create_n2_hamiltonian("cuda")),
                    ("synthetic_11_5_5",
                     create_synthetic_hamiltonian(11, 5, 5, "cuda", seed=0))):
        t0 = time.perf_counter()
        diag, el_t, tgt_t = ell_tables(h)
        torch.cuda.synchronize()
        table_s = time.perf_counter() - t0
        c, n = el_t.shape
        csr = csr_of_ell(diag, el_t, tgt_t)
        routes = ((True, False) if ell.psi_fits_on_chip(n, 2) else (False,))
        for b in (1, 2):
            psi = torch.randn((b, n), generator=gen, device="cuda")
            plain = ell.ell_spmv_reference(diag, el_t, tgt_t, psi)
            plain_ms = _median_ms(lambda: ell.ell_spmv_reference(
                diag, el_t, tgt_t, psi), 5)
            lib = library_products(csr, psi)
            bound_ms, bound_by = bound(8.0 * c * n + 4.0 * n * (1 + 2 * b),
                                       2.0 * b * c * n)
            for on_chip in routes:
                if not ell.psi_fits_on_chip(n, b) and on_chip:
                    continue
                got = ell.ell_spmv_cuda(diag, el_t, tgt_t, psi,
                                        psi_on_chip=on_chip)
                torch.cuda.synchronize()
                err = float((got - plain).abs().max())
                scale = float(plain.abs().max())
                lib_err = max(float((got - out).abs().max())
                              for out, _, _ in lib.values())
                if not err <= ELL_TOL:
                    raise RuntimeError(f"{name} B={b} on_chip={on_chip}: "
                                       f"kernel vs plain {err} > {ELL_TOL}")
                if not lib_err <= CSR_RTOL * scale:
                    raise RuntimeError(f"{name} B={b}: cuSPARSE vs kernel "
                                       f"{lib_err} > {CSR_RTOL} * {scale}")
                call = (lambda: ell.ell_spmv_cuda(
                    diag, el_t, tgt_t, psi, psi_on_chip=on_chip))
                ms = _median_ms(call, 50)
                device_ms = _median_ms(call, 10, 20)
                best = min((k for k in lib if b == 1 or "each" not in k),
                           key=lambda k: lib[k][1])
                row = {"table": name, "N": n, "C": c, "B": b,
                       "segments": ell.ell_segments(n, c),
                       "psi_on_chip": on_chip,
                       "max_abs_err": err, "max_abs_plain": scale,
                       "csr_max_abs_diff": lib_err,
                       "ms": ms, "device_ms": device_ms,
                       "plain_ms": plain_ms,
                       "library_ms": lib[best][1],
                       "library_device_ms": lib[best][2],
                       "library_call": best,
                       "library_forms_ms": {k: v[1:] for k, v in lib.items()},
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_share": bound_ms / ms,
                       "device_bound_share": bound_ms / device_ms,
                       "table_build_s": table_s}
                rows.append(row)
                print("ell_spmv: " + json.dumps(row))
        del diag, el_t, tgt_t, h, csr
        torch.cuda.empty_cache()
    return rows


def sweep_words(kind, n, tile_bits):
    """Word lists (theta, x_mask, z_mask, n_y): ``tfim`` is TFIM-24's low
    X words at half angle (h = 0.5, dt = 0.1/8) inside a 2^tile_bits
    tile; ``mixed`` adds XX and YY on neighbouring bits and a single Y
    whose Z mask reaches the top qubit, outside the tile; ``tfim_high`` is
    TFIM's X words on bits 14..n-1 forward then reversed, as the Trotter
    substep runs them; ``mixed_high`` has X on bits 13..n-1, XX and YY on
    neighbouring bits from 13|14 up and a Y whose Z mask reaches bit 0 and
    the top qubit."""
    if kind == "tfim":
        return [(-0.5 * 0.1 / 8 / 2, 1 << q, 0, 0) for q in range(tile_bits)]
    if kind == "tfim_high":
        high = [(-0.5 * 0.1 / 8 / 2, 1 << q, 0, 0) for q in range(14, n)]
        return high + high[::-1]
    lo = 0 if kind == "mixed" else 13
    hi = tile_bits if kind == "mixed" else n
    words = [(0.01 * (q + 1), 1 << q, 0, 0) for q in range(lo, hi)]
    for q in range(lo, hi - 1, 3):
        m = (1 << q) | (1 << (q + 1))
        words += [(0.02 * (q + 1), m, 0, 0), (-0.03 * (q + 1), m, m, 2)]
    if kind == "mixed":
        words.append((0.05, 1 << 2, (1 << 2) | (1 << (n - 1)), 1))
    else:
        words.append((0.05, 1 << 15, (1 << 15) | 1 | (1 << (n - 1)), 1))
    return words


def phase_x_sweep():
    """The x_sweep kernel against its plain version: contiguous tiles
    (TFIM-24's low words, the main path's shape, and a mixed list at
    tiles of 2^13 and 2^14) and gathered tiles (TFIM-24's high words, the
    main path's other shape, and a mixed list straddling bit 13|14) at
    n = 24 and 28, forward and reversed."""
    import torch
    from flow_guided_krylov_torch.ops import x_sweep as xs

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    cases = ((24, (("tfim", 13), ("tfim", 14), ("mixed", 13), ("mixed", 14),
                   ("tfim_high", 14), ("mixed_high", 14))),
             (28, (("mixed", 14), ("mixed_high", 14))))
    for n, kinds in cases:
        re = torch.randn(1 << n, generator=gen, device="cuda")
        im = torch.randn(1 << n, generator=gen, device="cuda")
        for kind, tile_bits in kinds:
            words = sweep_words(kind, n, tile_bits)
            for reverse in (False, True):
                seq = words[::-1] if reverse else words
                if kind.endswith("high"):
                    sweep = xs.make_gathered_sweeps(n, seq, tile_bits)
                    launches = len(xs.plan_sweeps(seq, n, tile_bits))
                else:
                    sweep = xs.make_x_sweep(n, words, tile_bits, reverse)
                    launches = 1
                plain = xs.x_sweep_reference(re, im, seq, n)
                got = sweep(re, im)
                torch.cuda.synchronize()
                err = max(float((g - p).abs().max())
                          for g, p in zip(got, plain))
                del got, plain
                if not err <= SWEEP_TOL:
                    raise RuntimeError(
                        f"x_sweep n={n} {kind} T={tile_bits} "
                        f"reverse={reverse}: {err} > {SWEEP_TOL}")
                ms = _median_ms(lambda: sweep(re, im), 20)
                device_ms = _median_ms(lambda: sweep(re, im), 10, 5)
                plain_ms = _median_ms(
                    lambda: xs.x_sweep_reference(re, im, seq, n), 3)
                # the function reads and writes the state once, however
                # many launches carry it; 8 flops an amplitude and word:
                # 4 products, 2 sums and the sign's 2 products
                bound_ms, bound_by = bound(16.0 * (1 << n),
                                           8.0 * len(words) * (1 << n))
                row = {"n": n, "words": kind, "n_words": len(words),
                       "tile_bits": tile_bits, "launches": launches,
                       "reverse": reverse, "max_abs_err": err, "ms": ms,
                       "device_ms": device_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "bound_share": bound_ms / ms,
                       "device_bound_share": bound_ms / device_ms}
                rows.append(row)
                print("x_sweep: " + json.dumps(row))
        del re, im
        torch.cuda.empty_cache()
    return rows


def phase_sweep_parts(n=24):
    """Where the x_sweep kernel's time goes at 2^n amplitudes: word lists
    that isolate its parts, each held against the plain version and timed
    back to back: a copy (no word: one load and one store), one register
    phase on bits 0..3 (a warp's lanes 64 bytes apart on the load) or on
    bits {0, 1, 12, 13} (lanes on consecutive 16 bytes), two and four
    phases, and TFIM-24's high words on a gathered tile."""
    import torch
    from flow_guided_krylov_torch.ops import x_sweep as xs
    gen = torch.Generator(device="cuda").manual_seed(2)
    re = torch.randn(1 << n, generator=gen, device="cuda")
    im = torch.randn(1 << n, generator=gen, device="cuda")
    th = -0.003125
    high = [(th, 1 << q, 0, 0) for q in range(14, n)]
    cases = {
        "copy": ([], 14),
        "x0..3, 1 phase": ([(th, 1 << q, 0, 0) for q in range(4)], 14),
        "x12,13, 1 phase": ([(th, 1 << q, 0, 0) for q in (12, 13)], 14),
        "x12,13,0..3, 2 phases": (
            [(th, 1 << q, 0, 0) for q in (12, 13, 0, 1, 2, 3)], 14),
        "tfim low, 14 words": ([(th, 1 << q, 0, 0) for q in range(14)], 14),
        "tfim high, 20 words": (high + high[::-1],
                                xs.plan_sweeps(high + high[::-1], n)[0][0]),
    }
    bound_ms, _ = bound(16.0 * (1 << n), 0.0)
    for name, (words, tile) in cases.items():
        table = torch.as_tensor(xs.sweep_table(words, n, tile), device="cuda")
        phases = int(((table[:, 5] >> 8) & 1).sum()) if words else 1
        fn = lambda: xs.x_sweep_cuda(re, im, table, n, tile)  # noqa: E731
        got = fn()
        want = xs.x_sweep_reference(re, im, words, n)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not err <= SWEEP_TOL:
            raise RuntimeError(f"x_sweep part {name}: {err} > {SWEEP_TOL}")
        device_ms = _median_ms(fn, 10, 10)
        print("x_sweep part: " + json.dumps({
            "words": name, "n": n, "phases": phases, "max_abs_err": err,
            "device_ms": device_ms, "bound_ms": bound_ms,
            "device_bound_share": bound_ms / device_ms}))


def stage3(h, fci, use_device_scoring):
    """bench.py::time_to_accuracy's HF-seeded loop, on the port."""
    from flow_guided_krylov_torch.krylov import (ResidualExpansionConfig,
                                                 SelectedCIExpander)
    cfg = ResidualExpansionConfig(
        max_iterations=40, configs_per_iteration=300,
        stagnation_threshold=1e-6, stagnation_patience=3,
        max_basis_size=min(h.n_valid_configs, 30_000))
    expander = SelectedCIExpander(h, cfg,
                                  use_device_scoring=use_device_scoring)
    basis = h.get_hf_state()[None, :]
    t0 = time.perf_counter()
    e = float("inf")
    for _ in range(cfg.max_iterations):
        out = expander.expand_basis(basis)
        basis, e = out["basis"], out["energy"]
        if e - fci < 1.6e-3 or not out["accepted"]:
            break
    return {"wall_s": time.perf_counter() - t0, "energy": e,
            "error_mha": 1000 * (e - fci), "basis_size": int(len(basis)),
            "timings_s": dict(expander.timings)}, basis


def phase_slice(device="cuda", molecule="n2"):
    import numpy as np
    import torch
    from flow_guided_krylov_torch.hamiltonians import MOLECULE_FACTORIES
    from flow_guided_krylov_torch.krylov import FlowGuidedSKQD, SKQDConfig
    from flow_guided_krylov_torch.ops import ell_spmv as ell

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    h = MOLECULE_FACTORIES[molecule](device)
    t0 = time.perf_counter()
    fci = h.fci_energy()
    print(f"{molecule} fci: {fci:.6f} Ha (n2 reference {FCI_N2_REF}), "
          f"oracle {time.perf_counter() - t0:.2f} s")
    if molecule == "n2" and abs(fci - FCI_N2_REF) > 1e-5:
        raise RuntimeError(f"N2 FCI {fci} vs reference {FCI_N2_REF}")

    # ---- the main path: stage 3 -> stage 4, counted launches ----------
    ell.ell_spmv_cuda.launches = 0
    s3, sci_basis = stage3(h, fci, use_device_scoring=None)
    cfg = SKQDConfig(evolution="ell", max_krylov_dim=8, time_step=0.1,
                     shots_per_krylov=50_000, seed=0)
    skqd = FlowGuidedSKQD(h, sci_basis, cfg)
    t0 = time.perf_counter()
    out = skqd.run_with_nf()
    sync()
    s4_wall = time.perf_counter() - t0
    launches = ell.ell_spmv_cuda.launches
    # ---------------------------------------------------------------------

    print("stage3 host scoring: " + json.dumps(s3))
    if not s3["error_mha"] < 1.6:
        raise RuntimeError(f"stage 3 error {s3['error_mha']} mHa >= 1.6")
    s3d, _ = stage3(h, fci, use_device_scoring=True)
    print("stage3 device scoring: " + json.dumps(s3d))
    if not s3d["error_mha"] < 1.6:
        raise RuntimeError(f"device-scored stage 3 {s3d['error_mha']} mHa")

    e4 = out["best_stable_energy"]
    s4 = {"nf_only_energy": out["nf_only_energy"],
          "best_stable_energy": e4, "error_mha": 1000 * (e4 - fci),
          "nf_basis_size": out["nf_basis_size"],
          "krylov_basis_sizes": out["krylov_basis_sizes"],
          "combined_sizes": out["combined_sizes"],
          "instabilities": out["instabilities"],
          "wall_s": s4_wall, "ell_launches": launches}
    print("stage4: " + json.dumps(s4))
    if not fci - 1e-6 <= e4 <= s3["energy"] + 1e-12:
        raise RuntimeError(f"stage 4 energy {e4} outside "
                           f"[{fci - 1e-6}, {s3['energy']}]")
    if molecule == "n2" and not (s4["error_mha"] < 1.6 and abs(
            s4["error_mha"] - STAGE4_N2_MHA) <= 0.01):
        raise RuntimeError(f"stage 4 error {s4['error_mha']} mHa: not "
                           f"< 1.6 and within 0.01 of {STAGE4_N2_MHA}")
    if launches <= 0:
        raise RuntimeError("stage 4 never launched the ELL kernel")

    # ---- checks and timings outside the counted run ----------------------
    psi0 = np.zeros(skqd.dim, complex)
    psi0[skqd._index_of(h.get_hf_state())[0]] = 1.0
    ref = skqd._evolve_scipy(psi0)
    evolve_err = float(np.abs(skqd.evolve(psi0) - ref).max())
    if not evolve_err < 1e-5:
        raise RuntimeError(f"ELL evolve vs scipy: {evolve_err}")
    times = {}
    for mode in ("ell", "dense"):
        s = FlowGuidedSKQD(h, sci_basis, SKQDConfig(evolution=mode))
        t0 = time.perf_counter()
        s.evolve(psi0)                       # builds the table / dense H
        first = time.perf_counter() - t0
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            s.evolve(psi0)
            walls.append(time.perf_counter() - t0)
        times[mode] = {"first_s": first, "warm_ms": 1e3 * min(walls)}
        del s
    print("evolve vs scipy max abs err: " + repr(evolve_err))
    print(f"evolve times (m=30 Lanczos, N={skqd.dim}): "
          + json.dumps(times))
    return launches


def tfim_free_fermion_energy(n: int, V: float, h: float) -> float:
    """Exact ground energy of the periodic nearest-neighbour TFIM chain
    H = -V sum Z_i Z_{i+1} - h sum X_i via Jordan-Wigner free fermions
    (even-parity / antiperiodic sector, exact for the finite chain);
    copied from examples/skqd_lattice_validation.py:54-59."""
    import numpy as np
    k = (2 * np.arange(n) + 1) * np.pi / n
    return float(-np.sum(np.sqrt(V ** 2 + h ** 2 - 2 * V * h * np.cos(k))))


def phase_spin(device="cuda", n_sites=24, shots=100_000, heis_sites=20):
    """TFIM-n_sites spin SKQD through ``auto`` -> Trotter, then one
    Heisenberg-hx evolve on ``device`` against the CPU."""
    import numpy as np
    import torch
    from flow_guided_krylov_torch.hamiltonians import (
        HeisenbergHamiltonian, TransverseFieldIsing, pack_spin_state)
    from flow_guided_krylov_torch.krylov import (
        SampleBasedKrylovDiagonalization, SKQDConfig)
    from flow_guided_krylov_torch.ops import x_sweep as xs

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    h_field = 0.5
    e_exact = tfim_free_fermion_energy(n_sites, 1.0, h_field)
    ham = TransverseFieldIsing(n_sites, V=1.0, h=h_field, periodic=True,
                               device=device)
    cfg = SKQDConfig(max_krylov_dim=10, shots_per_krylov=shots,
                     time_step=0.1, num_trotter_steps=8, lanczos_dim=12,
                     evolution="auto", seed=0)

    # ---- the main path: TFIM SKQD, counted launches --------------------
    xs.x_sweep_cuda.launches = 0
    xs._pauli_rotation_pair.cuda_calls = 0
    t0 = time.perf_counter()
    skqd = SampleBasedKrylovDiagonalization(
        ham, cfg, initial_state=pack_spin_state(0, n_sites))
    out = skqd.run()
    sync()
    wall = time.perf_counter() - t0
    launches = xs.x_sweep_cuda.launches
    plain_rotations = xs._pauli_rotation_pair.cuda_calls
    # ---------------------------------------------------------------------

    e = out["final_energy"]
    res = {"model": f"tfim{n_sites}", "h": h_field,
           "trotter": skqd.use_trotter,
           "exact_energy": e_exact, "energy": e,
           "error_mha": 1000 * (e - e_exact),
           "basis_size": out["basis_sizes"][-1],
           "basis_sizes": out["basis_sizes"], "wall_s": wall,
           "x_sweep_launches": launches,
           "plain_rotations_on_card": plain_rotations}
    if not skqd.use_trotter:
        raise RuntimeError("TFIM SKQD did not take the Trotter path")
    if not np.isfinite(out["energies"]).all():
        raise RuntimeError(f"non-finite energies {out['energies']}")
    if not e >= e_exact - 1e-6:
        raise RuntimeError(f"variational violation: {e} < {e_exact}")
    if not res["error_mha"] < 10.0:
        raise RuntimeError(f"TFIM SKQD error {res['error_mha']} mHa >= 10")
    if device == "cuda" and launches <= 0:
        raise RuntimeError("TFIM SKQD never launched the x_sweep kernel")
    if plain_rotations:
        raise RuntimeError(f"TFIM SKQD ran {plain_rotations} plain "
                           f"rotations on the card")
    if n_sites == 24:
        res["matches_earlier_runs"] = (
            res["basis_size"] == TFIM24_BASIS
            and abs(res["error_mha"] - TFIM24_MHA) <= TFIM24_MHA_TOL)
        if not res["matches_earlier_runs"]:
            print(f"tfim24 differs from the earlier runs: basis "
                  f"{res['basis_size']} (was {TFIM24_BASIS}), error "
                  f"{res['error_mha']!r} mHa (was {TFIM24_MHA})")

    # ---- breakdown and timings outside the counted run -------------------
    start = torch.zeros(skqd.dim, device=device)
    start[0] = 1.0
    zero = torch.zeros_like(start)
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        skqd._evolve_trotter(start, zero)
        sync()
        walls.append(time.perf_counter() - t0)
    res["warm_evolve_ms"] = 1e3 * statistics.median(walls[1:])
    t0 = time.perf_counter()
    for b in out["bases"]:
        skqd.compute_ground_state_energy(b)
    res["eigensolves_s"] = time.perf_counter() - t0
    if device == "cuda":
        res["evolve_profile"] = profile_evolve(skqd, start, zero)
    print("spin tfim: " + json.dumps(res))
    print("reproducibility: " + json.dumps(
        check_reproducible(skqd, ham, cfg, out["samples"], start, zero)))

    # ---- Heisenberg-hx evolve: card (kernel) vs CPU (plain) -------------
    neel = sum(1 << i for i in range(0, heis_sites, 2))
    states = {}
    for dev in dict.fromkeys((device, "cpu")):   # once when device is cpu
        s = SampleBasedKrylovDiagonalization(
            HeisenbergHamiltonian(heis_sites, 1.0, 1.0, 1.0,
                                  h_x=np.full(heis_sites, 0.3), device=dev),
            SKQDConfig(evolution="trotter"),
            initial_state=pack_spin_state(neel, heis_sites))
        re = torch.zeros(s.dim, device=dev)
        re[neel] = 1.0
        before = xs.x_sweep_cuda.launches
        plain = xs._pauli_rotation_pair.cuda_calls
        states[dev] = s._evolve_trotter(re, torch.zeros_like(re))
        sync()
        if dev == "cuda" and xs.x_sweep_cuda.launches == before:
            raise RuntimeError("Heisenberg evolve never launched x_sweep")
        if xs._pauli_rotation_pair.cuda_calls != plain:
            raise RuntimeError("Heisenberg evolve ran plain rotations on "
                               "the card")
    diff = max(float((a.cpu() - b).abs().max())
               for a, b in zip(states[device], states["cpu"]))
    print(f"heisenberg-hx{heis_sites} evolve {device} vs cpu: max abs diff "
          f"{diff!r} (tolerance {HEIS_EVOLVE_TOL})")
    if not diff <= HEIS_EVOLVE_TOL:
        raise RuntimeError(f"Heisenberg evolve {device} vs cpu: {diff}")
    return res


def check_reproducible(skqd, ham, cfg, samples, re, im):
    """One seed gives one run: an evolve repeated from one start, the
    sampler's cdf repeated on one evolved state, and a second instance's
    Krylov samples, all bit for bit.  On the card it also times a draw."""
    import torch
    from flow_guided_krylov_torch.krylov import skqd as skqd_mod
    a = skqd._evolve_trotter(re, im)
    b = skqd._evolve_trotter(re, im)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError("two evolves from one start differ")
    prob = a[0] ** 2 + a[1] ** 2
    gen = torch.Generator(device=prob.device).manual_seed(5)
    u = torch.rand(cfg.shots_per_krylov, device=prob.device, generator=gen)
    draws = skqd_mod._sample_idx_cdf(prob, u)
    for _ in range(9):
        if not torch.equal(skqd_mod._sample_idx_cdf(prob, u), draws):
            raise RuntimeError("the sampler drew twice differently")
    again = type(skqd)(ham, cfg, initial_state=skqd.initial_state)
    if again.generate_krylov_samples() != samples:
        raise RuntimeError("a second run with the same seed sampled "
                           "other configurations")
    res = {"evolves_equal": True, "draws_equal": True,
           "samples_equal": True}
    if prob.is_cuda:
        res["draw_ms"] = _median_ms(
            lambda: skqd_mod._sample_idx_cdf(prob, u), 10)
    return res


def profile_evolve(skqd, re, im):
    """Device time of one warm evolve by kernel, from torch.profiler:
    the x_sweep kernel, the other kernels, and the device's busy share of
    the host wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        skqd._evolve_trotter(re, im)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_us = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = ev.device_time_total
    total = sum(dev_us.values())
    sweep = sum(v for k, v in dev_us.items() if "x_sweep" in k)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_ms": total / 1e3,
            "x_sweep_ms": sweep / 1e3,
            "busy_share": total / 1e3 / wall_ms if wall_ms else None,
            "top_kernels_ms": {k[:60]: v / 1e3 for k, v in top}}


def main():
    os.environ.setdefault("FGK_INTEGRAL_CACHE",
                          os.path.join(ROOT, ".fgk_cache"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import flow_guided_krylov_torch  # noqa: F401  (fails outside the repo)
    from flow_guided_krylov_torch.ops.x_sweep import TILE_BITS
    phase_device()
    phase_build()
    rows = phase_kernel()
    sweep_rows = phase_x_sweep()
    phase_sweep_parts()
    launches = phase_slice()
    spin = phase_spin()
    main_row = next(r for r in rows if r["table"] == "n2" and r["B"] == 2
                    and r["psi_on_chip"])
    low = next(r for r in sweep_rows
               if r["n"] == 24 and r["words"] == "tfim"
               and r["tile_bits"] == TILE_BITS and not r["reverse"])
    high = next(r for r in sweep_rows
                if r["n"] == 24 and r["words"] == "tfim_high"
                and not r["reverse"])
    kernels = {"kernels": [{
        "name": "ell_spmv", "route": "cuda",
        "source": "flow_guided_krylov_torch/csrc/ell_spmv.cu",
        "replaces": "flow_guided_krylov_tpu/ops/pallas_spmv.py:50",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_share": main_row["bound_share"],
        "library_ms": main_row["library_ms"]}, {
        "name": "x_sweep", "route": "cuda",
        "source": "flow_guided_krylov_torch/csrc/x_sweep.cu",
        "replaces": "flow_guided_krylov_tpu/ops/pallas_trotter.py:66",
        "launches": spin["x_sweep_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in sweep_rows),
        "ms": low["ms"], "device_ms": low["device_ms"],
        "plain_ms": low["plain_ms"],
        "bound_ms": low["bound_ms"], "bound_by": low["bound_by"],
        "bound_share": low["bound_share"], "library_ms": None,
        "gathered_ms": high["ms"], "gathered_device_ms": high["device_ms"],
        "gathered_bound_ms": high["bound_ms"]}]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
