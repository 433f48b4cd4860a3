#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flow_guided_krylov_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernel from the sources in this
checkout, holds it against its plain torch version on the card, then
drives the port's molecular slice on N2/STO-3G (20 qubits, 14,400
determinants, 609 connections each) through its public entry points:

1. device and toolchain report (TF32 must be off);
2. ELL SpMV kernel vs plain version on two tables: N2's full space
   (14,400 x 609) and a synthetic 11-orbital (5a, 5b) space
   (213,444 x 1,260, random integrals from a seed), B = 1 and 2;
3. stage 3: HF-seeded Selected-CI to < 1.6 mHa against the port's own FCI
   oracle, host scoring and then forced device scoring;
4. stage 4: FlowGuidedSKQD on the stage-3 basis with ELL evolution
   through the kernel, checked against FCI, the stage-3 energy and the
   f64 scipy propagator; one dense evolve is timed beside an ELL one.

Every phase raises on failure (non-zero exit).  The last two lines are
one JSON object with the kernel's numbers and the result line
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

ROOT = os.path.dirname(os.path.abspath(__file__))
FCI_N2_REF = -107.654121          # results/final_benchmark_all.txt:279


def _cmd(args):
    out = subprocess.run(args, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def _median_ms(fn, reps):
    """Median of ``reps`` warm calls, each timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def phase_kernel():
    import torch
    from flow_guided_krylov_torch.hamiltonians import (
        create_n2_hamiltonian, create_synthetic_hamiltonian)
    from flow_guided_krylov_torch.ops import ell_spmv as ell
    from flow_guided_krylov_torch.utils.build import BUILD_DIR

    t0 = time.perf_counter()
    ell._library()
    build_s = time.perf_counter() - t0
    logs = [f for f in os.listdir(BUILD_DIR) if f.startswith("ell_spmv")
            and f.endswith(".log")]
    for f in logs:
        with open(os.path.join(BUILD_DIR, f)) as fh:
            for line in fh.read().splitlines():
                if "registers" in line or "spill" in line:
                    print("ptxas: " + line.strip())
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a)")
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
        for b in (1, 2):
            psi = torch.randn((b, n), generator=gen, device="cuda")
            plain = ell.ell_spmv_reference(diag, el_t, tgt_t, psi)
            got = ell.ell_spmv_cuda(diag, el_t, tgt_t, psi)
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            scale = float(plain.abs().max())
            if not err <= 1e-5 * scale:
                raise RuntimeError(f"{name} B={b}: kernel vs plain "
                                   f"{err} > 1e-5 * {scale}")
            ms = _median_ms(lambda: ell.ell_spmv_cuda(diag, el_t, tgt_t,
                                                      psi), 50)
            plain_ms = _median_ms(lambda: ell.ell_spmv_reference(
                diag, el_t, tgt_t, psi), 5)
            gbytes = (8.0 * c * n + 4.0 * n * (1 + 2 * b)) / 1e9
            row = {"table": name, "N": n, "C": c, "B": b,
                   "max_abs_err": err, "max_abs_plain": scale,
                   "ms": ms, "plain_ms": plain_ms,
                   "table_GB_per_s": gbytes / (ms / 1e3),
                   "table_build_s": table_s}
            rows.append(row)
            print("ell_spmv: " + json.dumps(row))
        del diag, el_t, tgt_t, h
        torch.cuda.empty_cache()
    return rows


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


def main():
    os.environ.setdefault("FGK_INTEGRAL_CACHE",
                          os.path.join(ROOT, ".fgk_cache"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import flow_guided_krylov_torch  # noqa: F401  (fails outside the repo)
    phase_device()
    rows = phase_kernel()
    launches = phase_slice()
    main_row = next(r for r in rows if r["table"] == "n2" and r["B"] == 2)
    kernels = {"kernels": [{
        "name": "ell_spmv", "route": "cuda",
        "source": "flow_guided_krylov_torch/csrc/ell_spmv.cu",
        "replaces": "flow_guided_krylov_tpu/ops/pallas_spmv.py:50",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"]}]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
