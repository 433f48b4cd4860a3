"""Lattice-model SKQD validation (TFIM / Heisenberg).

Counterpart of the JAX package's ``examples/skqd_lattice_validation.py``:

* ``tfim``        — pure SKQD from |0...0> vs NF-only vs NF+SKQD
* ``heisenberg``  — the same three modes from the Neel state
* ``convergence`` — Krylov convergence scan over the transverse field h;
                    ``--scan`` is an alias
* ``discovery``   — configuration-discovery comparison: which configs each
                    method finds, their overlap, and the energy the
                    Krylov-unique configs buy
* ``large``       — large-spin SKQD through the statevector-Trotter path
                    (the x_sweep kernel past 17 sites) or the S_z sector
                    (the ELL kernel); with ``--pipeline`` the four stages,
                    with ``--sci`` Selected-CI alone, with ``--study`` a
                    convergence study, with ``--exact-full`` the exact
                    full-space ground state

Oracles: exact dense diagonalization built independently from Pauli words
(n <= 14, ``postprocessing/projected_hamiltonian.py``); for larger
periodic nearest-neighbour TFIM chains the free-fermion (Jordan-Wigner)
closed form; otherwise sparse host Lanczos (``eigsh``) over the full
space.  None of them goes through the device kernels.

Usage:
  python -m flow_guided_krylov_torch.examples.skqd_lattice_validation --system tfim --spins 10
  python -m flow_guided_krylov_torch.examples.skqd_lattice_validation --system discovery
  python -m flow_guided_krylov_torch.examples.skqd_lattice_validation --system large --spins 22
  python -m flow_guided_krylov_torch.examples.skqd_lattice_validation --scan --device cpu
"""

import argparse
import json
import time
from math import comb

import numpy as np

from ..hamiltonians import (HeisenbergHamiltonian, TransverseFieldIsing,
                            extract_coeffs_and_paulis)
from ..hamiltonians.base import lowest_pairs
from ..hamiltonians.spin import pack_spin_state, spin_state_int
from ..krylov import (ResidualExpansionConfig, SKQDConfig,
                      SampleBasedKrylovDiagonalization,
                      iterative_residual_expansion)
from ..pipeline import FlowGuidedKrylovPipeline, PipelineConfig
from ..postprocessing import (ProjectedHamiltonianBuilder, dmrg_ground_state,
                              exact_fullspace_ground_state)
from . import add_device_flag, resolve_device


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

def tfim_free_fermion_energy(n: int, V: float, h: float) -> float:
    """Exact ground energy of the periodic nearest-neighbour TFIM chain
    H = -V sum Z_i Z_{i+1} - h sum X_i via Jordan-Wigner free fermions
    (even-parity / antiperiodic sector, exact for the finite chain)."""
    k = (2 * np.arange(n) + 1) * np.pi / n
    return float(-np.sum(np.sqrt(V ** 2 + h ** 2 - 2 * V * h * np.cos(k))))


def exact_oracle(ham) -> float:
    """Independent exact ground energy (not the kernel path when possible):
    dense Pauli-word build for n <= 14; free-fermion closed form for
    periodic L=1 TFIM; sparse Lanczos over the full space otherwise."""
    n = ham.n_sites
    if n <= 14:
        coeffs, words = extract_coeffs_and_paulis(ham)
        builder = ProjectedHamiltonianBuilder.from_coeffs_and_words(
            coeffs, words)
        states = np.arange(1 << n, dtype=np.uint64)
        return float(np.linalg.eigvalsh(builder.build_dense(states))[0])
    if isinstance(ham, TransverseFieldIsing) and ham.L == 1 and ham.periodic:
        return tfim_free_fermion_energy(n, ham.V, ham.h)
    states = np.arange(1 << n, dtype=np.uint32)[:, None]
    H = ham.to_sparse(states)
    return float(lowest_pairs(H)[0][0])


def basis_energy(ham, basis: np.ndarray) -> float:
    """Ground energy of H projected onto ``basis`` (float64 eigensolve)."""
    return float(ham.exact_ground_state(np.atleast_2d(basis), k=1)[0][0])


def make_hamiltonian(model: str, n_spins: int, h_field: float,
                     device="cuda"):
    device = resolve_device(device)
    if model == "tfim":
        ham = TransverseFieldIsing(n_spins, V=1.0, h=h_field, periodic=True,
                                   device=device)
        init = pack_spin_state(0, n_spins)               # |0...0>
    elif model == "heisenberg-hx":
        # non-conserving chain: a uniform transverse field breaks S_z
        # conservation, so the solvers face the FULL 2^n space (no
        # sector restriction); oracle = DMRG (open chain, h_x supported)
        ham = HeisenbergHamiltonian(n_spins, 1.0, 1.0, 1.0,
                                    h_x=np.full(n_spins, h_field),
                                    device=device)
        neel = sum(1 << i for i in range(0, n_spins, 2))
        init = pack_spin_state(neel, n_spins)
    else:
        # small h_z perturbation on site 0 breaks the ground degeneracy
        # (reference ``skqd_lattice_validation.py:296-316``)
        h_z = np.zeros(n_spins)
        h_z[0] = h_field
        ham = HeisenbergHamiltonian(n_spins, 1.0, 1.0, 1.0, h_z=h_z,
                                    device=device)
        neel = sum(1 << i for i in range(0, n_spins, 2))
        init = pack_spin_state(neel, n_spins)
    return ham, init


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def run_pure_skqd(ham, init, krylov_dim: int, shots: int, seed: int = 0,
                  evolution: str = "auto", lanczos_dim: int = 30,
                  time_step: float = 0.1, final_only: bool = False) -> dict:
    skqd = SampleBasedKrylovDiagonalization(
        ham, SKQDConfig(max_krylov_dim=krylov_dim, shots_per_krylov=shots,
                        time_step=time_step, seed=seed, evolution=evolution,
                        lanczos_dim=lanczos_dim),
        initial_state=init)
    out = skqd.run(final_only=final_only)
    return {"energy": out["final_energy"],
            "basis": out["bases"][-1],
            "basis_size": out["basis_sizes"][-1],
            "energies_vs_k": out["energies"],
            "trotter": skqd.use_trotter,
            "skqd": skqd}


def run_nf_pipeline(ham, e_exact, max_epochs: int, skip_skqd: bool,
                    krylov_dim: int = 12, shots: int = 100_000,
                    seed: int = 0):
    """NF-only (skip_skqd) or NF+SKQD pipeline on a spin Hamiltonian
    (reference modes B/C)."""
    # use_particle_conserving_flow stays on: magnetization-conserving
    # lattices (XXZ) get the k-hot SzConservingFlow, TFIM-class systems
    # fall back to the discrete RealNVP sampler automatically
    cfg = PipelineConfig(
        use_residual_expansion=False,
        skip_skqd=skip_skqd,
        max_krylov_dim=krylov_dim,
        shots_per_krylov=shots,
        max_epochs=max_epochs,
        seed=seed,
        verbose=False,
    )
    pipe = FlowGuidedKrylovPipeline(ham, config=cfg, exact_energy=e_exact)
    results = pipe.run()
    return results, pipe


# ---------------------------------------------------------------------------
# Experiments
# ---------------------------------------------------------------------------

def run_three_mode_experiment(model: str, n_spins: int, h_field: float,
                              krylov_dim: int, shots: int,
                              max_epochs: int, device="cuda") -> dict:
    """Pure SKQD vs NF-only vs NF+SKQD (reference experiments 1 and 2)."""
    ham, init = make_hamiltonian(model, n_spins, h_field, device)
    e_exact = exact_oracle(ham)
    t0 = time.time()

    pure = run_pure_skqd(ham, init, krylov_dim, shots)
    nf_res, _ = run_nf_pipeline(ham, e_exact, max_epochs, skip_skqd=True)
    comb_res, _ = run_nf_pipeline(ham, e_exact, max_epochs, skip_skqd=False,
                                  krylov_dim=krylov_dim, shots=shots)

    e_skqd = pure["energy"]
    e_nf = nf_res["combined_energy"]
    e_comb = comb_res["combined_energy"]
    errs = {"skqd": 1000 * abs(e_skqd - e_exact),
            "nf": 1000 * abs(e_nf - e_exact),
            "combined": 1000 * abs(e_comb - e_exact)}
    best = min(errs, key=errs.get)

    print(f"\n{'=' * 66}\n{model.upper()} RESULTS ({n_spins} spins, "
          f"h={h_field}):\n{'=' * 66}")
    print(f"{'Method':<22}{'Basis':>8}{'Energy':>16}{'Err (mHa)':>12}")
    print("-" * 58)
    print(f"{'Exact':<22}{'-':>8}{e_exact:>16.8f}{0.0:>12.4f}")
    print(f"{'Pure SKQD':<22}{pure['basis_size']:>8}{e_skqd:>16.8f}"
          f"{errs['skqd']:>12.4f}")
    print(f"{'NF only':<22}{nf_res['nf_basis_size']:>8}{e_nf:>16.8f}"
          f"{errs['nf']:>12.4f}")
    print(f"{'NF + SKQD':<22}{'-':>8}{e_comb:>16.8f}"
          f"{errs['combined']:>12.4f}")
    print(f"Best method: {best} | SKQD "
          f"{'OUTPERFORMS' if errs['skqd'] < errs['nf'] else 'underperforms'}"
          f" NF | wall {time.time() - t0:.1f}s")
    return {"model": model, "n_spins": n_spins, "h": h_field,
            "exact_energy": e_exact, "skqd_energy": e_skqd,
            "nf_energy": e_nf, "combined_energy": e_comb,
            "errors_mha": errs, "best": best,
            "skqd_basis_size": pure["basis_size"],
            "nf_basis_size": nf_res["nf_basis_size"]}


def run_convergence_scan(n_spins: int, krylov_dim: int, shots: int,
                         h_values=(0.1, 0.3, 0.5, 1.0, 2.0),
                         device="cuda") -> list:
    """Krylov convergence vs transverse field h (reference experiment 3;
    regression target SKQD_VALIDATION_REPORT.md:58-64)."""
    rows = []
    for hh in h_values:
        ham, init = make_hamiltonian("tfim", n_spins, hh, device)
        e_exact = exact_oracle(ham)
        pure = run_pure_skqd(ham, init, krylov_dim, shots)
        rows.append({"h": hh, "exact": e_exact,
                     "error_mha": 1000 * (pure["energy"] - e_exact),
                     "basis_size": pure["basis_size"],
                     "energies_vs_k": [round(1000 * (e - e_exact), 4)
                                       for e in pure["energies_vs_k"]]})
    print(f"\n{'h':>5}{'err (mHa)':>12}{'basis':>8}   (full space "
          f"{1 << n_spins})")
    for r in rows:
        print(f"{r['h']:>5}{r['error_mha']:>12.4f}{r['basis_size']:>8}")
    print("Expected: lower h -> sparser ground state -> faster convergence")
    return rows


def run_discovery_comparison(n_spins: int, h_field: float, krylov_dim: int,
                             shots: int, max_epochs: int,
                             device="cuda") -> dict:
    """Which configurations each method discovers (reference experiment 4,
    ``skqd_lattice_validation.py:513-606``)."""
    ham, init = make_hamiltonian("tfim", n_spins, h_field, device)
    e_exact = exact_oracle(ham)
    t0 = time.time()

    pure = run_pure_skqd(ham, init, krylov_dim, shots)
    krylov_set = set(int(x) for x in np.asarray(pure["basis"])[:, 0])

    nf_res, pipe = run_nf_pipeline(ham, e_exact, max_epochs, skip_skqd=True)
    nf_set = set(int(x) for x in np.asarray(pipe.nf_basis)[:, 0])

    krylov_only = krylov_set - nf_set
    nf_only = nf_set - krylov_set
    both = krylov_set & nf_set
    combined = krylov_set | nf_set

    def to_basis(s):
        return np.array(sorted(s), np.uint32)[:, None]

    e_nf = basis_energy(ham, to_basis(nf_set))
    e_krylov = pure["energy"]
    e_comb = basis_energy(ham, to_basis(combined))
    err_nf = 1000 * abs(e_nf - e_exact)
    err_krylov = 1000 * abs(e_krylov - e_exact)
    err_comb = 1000 * abs(e_comb - e_exact)

    print(f"\n{'=' * 66}\nDISCOVERY COMPARISON (TFIM {n_spins} spins, "
          f"h={h_field}):\n{'=' * 66}")
    print(f"Krylov-only configs: {len(krylov_only)}   "
          f"NF-only: {len(nf_only)}   both: {len(both)}   "
          f"combined: {len(combined)}")
    print(f"{'Basis':<22}{'Size':>8}{'Energy':>16}{'Err (mHa)':>12}")
    print("-" * 58)
    print(f"{'Exact':<22}{'-':>8}{e_exact:>16.8f}{0.0:>12.4f}")
    print(f"{'NF only':<22}{len(nf_set):>8}{e_nf:>16.8f}{err_nf:>12.4f}")
    print(f"{'Krylov only':<22}{len(krylov_set):>8}{e_krylov:>16.8f}"
          f"{err_krylov:>12.4f}")
    print(f"{'Combined':<22}{len(combined):>8}{e_comb:>16.8f}"
          f"{err_comb:>12.4f}")
    print(f"Krylov-unique configs improve NF energy by "
          f"{err_nf - err_comb:.4f} mHa | wall {time.time() - t0:.1f}s")
    if krylov_only:
        print(f">>> KRYLOV FOUND {len(krylov_only)} CONFIGS NF MISSED <<<")
    return {"n_spins": n_spins, "h": h_field, "exact_energy": e_exact,
            "krylov_only": len(krylov_only), "nf_only": len(nf_only),
            "both": len(both), "combined": len(combined),
            "errors_mha": {"nf": err_nf, "krylov": err_krylov,
                           "combined": err_comb},
            "improvement_mha": err_nf - err_comb}


def run_large_spin(n_spins: int, h_field: float, krylov_dim: int,
                   shots: int, model: str = "tfim", device="cuda") -> dict:
    """Large-spin SKQD (new capability; VERDICT round-1 item 8).

    TFIM (non-conserving): the 2^n space is never enumerated; evolution is
    Trotterized Pauli rotations on a device-resident statevector and the
    projected H covers only sampled configs.

    Heisenberg (conserving): SKQD works in the fixed-magnetization sector
    (Heisenberg-24: 2,704,156 of 16.7M states) with exact on-device ELL
    Lanczos evolution — no Trotter error.
    """
    ham, init = make_hamiltonian(model, n_spins, h_field, device)
    t0 = time.time()
    # dt=0.1 keeps ||H dt|| small: a 12-dim Lanczos propagator is plenty
    # and halves the per-step matvec count on million-state sectors
    pure = run_pure_skqd(ham, init, krylov_dim, shots, lanczos_dim=12)
    res = {
        "model": model, "n_spins": n_spins, "h": h_field,
        "hilbert_dim": 1 << n_spins,
        "trotter_path": pure["trotter"],
        "skqd_energy": pure["energy"],
        "basis_size": pure["basis_size"],
        "wall_s": round(time.time() - t0, 1),
    }
    if model == "tfim":
        e_exact = exact_oracle(ham)      # free-fermion closed form
        res["exact_energy"] = e_exact
        res["error_mha"] = 1000 * (pure["energy"] - e_exact)
        assert pure["trotter"], "expected the statevector Trotter path"
    else:
        # a conserving model normally evolves in the fixed-S_z sector, but
        # sectors past the ELL memory budget legitimately route to Trotter —
        # report which path ran instead of asserting
        res["sector_path"] = not pure["trotter"]
        if res["sector_path"]:
            # oracle: exact sector ground state (device ELL Lanczos + host
            # f64 refinement) — every large-sector claim carries an error
            t1 = time.time()
            e_exact = pure["skqd"].exact_subspace_energy()
            res["exact_energy"] = e_exact
            res["error_mha"] = 1000 * (pure["energy"] - e_exact)
            res["oracle_wall_s"] = round(time.time() - t1, 1)
    print(json.dumps(res))
    return res


def run_large_spin_pipeline(model: str, n_spins: int, h_field: float,
                            krylov_dim: int, shots: int,
                            max_epochs: int, sci_iters: int = 0,
                            sci_per_iter: int = 0,
                            sci_growth: float = 0.0, device="cuda") -> dict:
    """Full 4-stage pipeline on a large lattice (Heisenberg-24: the
    2.7M-state sector through SzConservingFlow + PT2 + sector-ELL SKQD).

    For magnetization-conserving models the exact sector ground state is
    computed as the oracle (device ELL Lanczos + host f64 refinement), so
    the pipeline claim carries an error like every other record."""
    ham, init = make_hamiltonian(model, n_spins, h_field, device)

    e_exact = None
    if getattr(ham, "conserves_magnetization", False):
        oracle_skqd = SampleBasedKrylovDiagonalization(
            ham, SKQDConfig(), initial_state=init)
        if oracle_skqd.subspace is not None:
            t_or = time.time()
            e_exact = oracle_skqd.exact_subspace_energy()
            print(f"sector oracle: E_exact={e_exact:.8f} "
                  f"({time.time() - t_or:.1f} s)")
            del oracle_skqd

    cfg = PipelineConfig(max_epochs=max_epochs,
                         min_epochs=min(50, max_epochs // 2),
                         samples_per_batch=2048,
                         max_krylov_dim=krylov_dim,
                         shots_per_krylov=shots, verbose=True)
    pipe = FlowGuidedKrylovPipeline(ham, cfg, exact_energy=e_exact)
    # stage-3 depth overrides, applied after adapt_to_system_size so the
    # tier caps don't claw them back (the deep-SCI records show the
    # sector floor is PT2-exhaustion, not the tier budget)
    if sci_iters:
        pipe.config.residual_iterations = sci_iters
    if sci_per_iter:
        pipe.config.residual_configs_per_iter = sci_per_iter
    if sci_growth:
        pipe.config.residual_growth_factor = sci_growth
    t0 = time.time()
    out = pipe.run()
    e_ref = float(ham.diagonal_np(init[None, :])[0])
    res = {
        "experiment": "large-pipeline", "model": model, "n_spins": n_spins,
        "h": h_field, "sector_dim": pipe.n_valid,
        "flow": type(pipe.flow).__name__,
        "reference_product_energy": e_ref,
        "final_energy": out["final_energy"],
        "correlation_recovered": e_ref - out["final_energy"],
        "wall_s": round(time.time() - t0, 1),
    }
    if e_exact is not None:
        res["exact_energy"] = e_exact
        res["error_mha"] = 1000 * (out["final_energy"] - e_exact)
    print(json.dumps(res))
    return res


# largest enumerated sector the Lanczos + host-f64-refine oracle handles
# on one chip + this host; beyond it the DMRG oracle takes over
SECTOR_ORACLE_MAX_DIM = 12_000_000


def run_large_spin_sci(model: str, n_spins: int, h_field: float,
                       iters: int = 100, per_iter: int = 4000,
                       max_basis: int = 300_000,
                       growth: float = 0.0,
                       pt2_cap: int = 0,
                       threshold: float = 1e-4,
                       screen: float = 0.0,
                       sort_rows: int = 0, device="cuda") -> dict:
    """Seed-state-seeded deep Selected-CI on a spin sector (stage-3
    machinery alone — the spin analog of the molecular ``--mode sci``).

    Round-3 motivation: the Heisenberg-24 pipeline's PT2 stage was still
    descending ~6 mHa/round when its iteration cap hit; PT2-selected
    states are far better per-state than SKQD-sampled ones, so a deep SCI
    run probes how far the 2.7M-state sector can be pushed on one chip.
    Every claim carries the exact-sector-oracle error."""
    ham, init = make_hamiltonian(model, n_spins, h_field, device)
    # conserving models: force the enumerated-sector path even when the
    # sector's ELL table exceeds the (conservative) connection-table
    # budget — the oracle only builds the table transiently, and a
    # 10.4M-state C(26,13) sector at 27 entries/state (~2.3 GB) fits the card
    conserving = getattr(ham, "conserves_magnetization", False)
    multiword = getattr(ham, "pack_words", 1) == 2
    if multiword:
        # 32..64 sites (the 2xuint32 frontier): the SKQD sector machinery
        # is single-word, and these sectors are beyond enumeration anyway
        # (C(32,16) = 601M states) — go straight to the SCI + MPS oracle
        skqd = None
        n_up = int(bin(spin_state_int(init)).count("1"))
        sector_dim = comb(n_spins, n_up) if conserving else (1 << n_spins)
        has_subspace = conserving
    else:
        skqd = SampleBasedKrylovDiagonalization(
            ham, SKQDConfig(evolution="ell" if conserving else "auto"),
            initial_state=init)
        sector_dim = skqd.dim
        has_subspace = skqd.subspace is not None
    oracle = None
    if has_subspace:
        if skqd is not None and sector_dim <= SECTOR_ORACLE_MAX_DIM:
            e_exact = skqd.exact_subspace_energy()
            oracle = "sector-lanczos+f64-refine"
        else:
            # beyond the device-Lanczos + host-CSR-refine capacity
            # (Heisenberg-28: C(28,14) = 40.1M states) the MPS oracle
            # takes over: methodologically independent, and for the open
            # AFM chain Lieb-Mattis puts the GLOBAL ground state in the
            # S_z = 0 sector — asserted via the measured magnetization
            e_exact, dinfo = dmrg_ground_state(ham, max_bond=256,
                                               sweeps=12)
            # Lieb-Mattis (open AFM chain): S_tot = 0 for even N, 1/2
            # for odd N — the measured magnetization must match.
            want_sz = 0.5 if n_spins % 2 else 0.0
            assert abs(abs(dinfo["total_sz"]) - want_sz) < 1e-4, \
                f"DMRG ground state S_z={dinfo['total_sz']}, expected ±{want_sz}"
            # Odd N: S_z = ±1/2 are split by the site-0 h_z perturbation
            # and DMRG relaxes into the true ground sector; flip the Neel
            # seed's parity if it sits in the other one so the SCI
            # explores the sector the oracle energy belongs to.
            init_sz = int(bin(spin_state_int(init)).count("1")) \
                - n_spins / 2.0
            if want_sz and init_sz * dinfo["total_sz"] < 0:
                init = pack_spin_state(
                    sum(1 << i for i in range(1, n_spins, 2)), n_spins)
                print(f"  (odd chain: DMRG ground sector S_z="
                      f"{dinfo['total_sz']:+.2f}; Neel seed flipped)")
            oracle = (f"dmrg(m={dinfo['max_bond']}, "
                      f"trunc={dinfo['truncation_error']:.1e})")
    else:
        # non-conserving models span the full 2^n space; the
        # free-fermion / dense oracle still gives an exact error when
        # one is closed-form or small enough, and open non-conserving
        # Heisenberg chains (heisenberg-hx) get the DMRG oracle
        closed_form = (isinstance(ham, TransverseFieldIsing)
                       and ham.L == 1 and ham.periodic)
        if n_spins <= 14 or closed_form:
            e_exact = exact_oracle(ham)
        elif (isinstance(ham, HeisenbergHamiltonian)
              and not ham.periodic):
            e_exact, dinfo = dmrg_ground_state(ham, max_bond=256,
                                               sweeps=12)
            oracle = (f"dmrg(m={dinfo['max_bond']}, "
                      f"trunc={dinfo['truncation_error']:.1e})")
        else:
            # any other non-conserving spin model: the full-space exact
            # ED (identity-ELL device Lanczos + slab f64 refine) is the
            # oracle up to the memory gate (~2^24 at nearest-neighbour C)
            try:
                e_exact = exact_fullspace_ground_state(ham)["energy"]
                oracle = "fullspace-lanczos+slab-refine"
            except (MemoryError, NotImplementedError):
                e_exact = None
    cfg = ResidualExpansionConfig(
        max_iterations=iters, configs_per_iteration=per_iter,
        growth_factor=growth, residual_threshold=threshold,
        stagnation_threshold=1e-6, stagnation_patience=3,
        source_screen=screen, pt2_sort_rows=sort_rows,
        max_basis_size=min(sector_dim, max_basis))
    t0 = time.time()
    out = iterative_residual_expansion(ham, init[None, :], cfg,
                                       verbose=True, pt2_correct=True,
                                       pt2_cap=pt2_cap or None)
    res = {"experiment": "large-sci", "model": model, "n_spins": n_spins,
           "h": h_field, "sector_dim": int(sector_dim),
           "final_energy": float(out["energy"]),
           "basis_size": int(len(out["basis"])),
           "iterations": int(out["n_iterations"]),
           "wall_s": round(time.time() - t0, 1)}
    if "pt2_de2" in out:
        res["pt2_de2"] = out["pt2_de2"]
        res["pt2_corrected_energy"] = out["pt2_corrected_energy"]
        res["pt2_exact"] = out["pt2_exact"]
    if e_exact is not None:
        res["exact_energy"] = e_exact
        res["error_mha"] = 1000 * (out["energy"] - e_exact)
        if oracle is not None:
            res["oracle"] = oracle
        if "pt2_corrected_energy" in res:
            res["corrected_error_mha"] = 1000 * (res["pt2_corrected_energy"]
                                                 - e_exact)
    print(json.dumps(res))
    return res


def run_exact_fullspace(model: str, n_spins: int, h_field: float,
                        device="cuda") -> dict:
    """EXACT ground state of the full 2^n space on one chip — identity-ELL
    device Lanczos + host f64 refine (`exact_fullspace_ground_state`),
    cross-checked against an independent oracle (free-fermion for periodic
    TFIM, MPS DMRG for open transverse-field Heisenberg chains).

    This is the route that retires the sampled-basis error at n <= ~24
    where no conserved sector exists: the TFIM-24 critical point, whose
    dense ground state caps every subspace method (SKQD 236 mHa, deep SCI
    60 mHa), is EXACTLY solvable on the device."""
    ham, _ = make_hamiltonian(model, n_spins, h_field, device)
    t0 = time.time()
    out = exact_fullspace_ground_state(ham, verbose=True)
    res = {"experiment": "exact-fullspace", "model": model,
           "n_spins": n_spins, "h": h_field, "dim": out["dim"],
           "energy": out["energy"], "wall_s": round(time.time() - t0, 1)}
    for k in ("e_device", "e_rayleigh_f32vec", "route", "lanczos_m",
              "restarts", "wall_build_s", "wall_device_s", "wall_refine_s",
              "refine_matvecs", "cached"):
        if k in out:
            res[k] = out[k]
    # independent oracle cross-check
    e_oracle, oracle = None, None
    if isinstance(ham, TransverseFieldIsing) and ham.L == 1 and ham.periodic:
        e_oracle, oracle = exact_oracle(ham), "free-fermion"
    elif n_spins <= 14:
        e_oracle, oracle = exact_oracle(ham), "dense"
    elif isinstance(ham, HeisenbergHamiltonian) and not ham.periodic:
        e_oracle, dinfo = dmrg_ground_state(ham, max_bond=256, sweeps=12)
        oracle = (f"dmrg(m={dinfo['max_bond']}, "
                  f"trunc={dinfo['truncation_error']:.1e})")
    if e_oracle is not None:
        res["oracle"] = oracle
        res["oracle_energy"] = e_oracle
        res["error_mha"] = 1000 * (out["energy"] - e_oracle)
    print(json.dumps(res))
    return res


def run_large_convergence_study(n_spins: int, h_field: float,
                                points=None, device="cuda") -> list:
    """Convergence study at the large-spin frontier (VERDICT round 2
    item 6): scan Krylov dimension / shots / Trotter dt and record the
    error trend against the free-fermion oracle instead of one point."""
    ham, init = make_hamiltonian("tfim", n_spins, h_field, device)
    e_exact = exact_oracle(ham)
    if points is None:
        points = [(12, 100_000, 0.1), (16, 100_000, 0.1),
                  (16, 300_000, 0.1), (20, 300_000, 0.1),
                  (16, 300_000, 0.05)]
    rows = []
    for k, shots, dt in points:
        t0 = time.time()
        pure = run_pure_skqd(ham, init, k, shots, time_step=dt,
                             final_only=True)
        row = {"n_spins": n_spins, "h": h_field, "krylov_dim": k,
               "shots": shots, "dt": dt,
               "basis_size": pure["basis_size"],
               "energy": pure["energy"],
               "error_mha": 1000 * (pure["energy"] - e_exact),
               "wall_s": round(time.time() - t0, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(f"\nTFIM-{n_spins} h={h_field} (exact {e_exact:.6f}):")
    print(f"{'k':>4}{'shots':>9}{'dt':>7}{'basis':>10}{'err (mHa)':>12}"
          f"{'wall (s)':>10}")
    for r in rows:
        print(f"{r['krylov_dim']:>4}{r['shots']:>9}{r['dt']:>7}"
              f"{r['basis_size']:>10}{r['error_mha']:>12.3f}"
              f"{r['wall_s']:>10.1f}")
    return rows


# ---------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--system", "-s", default="tfim",
                   choices=["tfim", "heisenberg", "convergence",
                            "discovery", "large", "all"])
    p.add_argument("--spins", type=int, default=10)
    p.add_argument("--h", type=float, default=0.5,
                   help="transverse field (tfim) / h_z perturbation "
                        "(heisenberg)")
    p.add_argument("--krylov-dim", type=int, default=12)
    p.add_argument("--shots", type=int, default=100_000)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--scan", action="store_true",
                   help="alias for --system convergence")
    p.add_argument("--pipeline", action="store_true",
                   help="with --system large: run the FULL 4-stage "
                        "pipeline instead of pure SKQD")
    p.add_argument("--study", action="store_true",
                   help="with --system large: TFIM convergence study over "
                        "(krylov dim, shots, dt) against the free-fermion "
                        "oracle")
    p.add_argument("--study-points", default=None,
                   help="override study grid: 'k,shots,dt;k,shots,dt;...' "
                        "(e.g. '12,100000,0.1;16,300000,0.05')")
    p.add_argument("--sci", action="store_true",
                   help="with --system large: seed-state-seeded deep "
                        "Selected-CI (stage-3 machinery alone), "
                        "oracle-checked")
    p.add_argument("--sci-iters", type=int, default=80)
    p.add_argument("--sci-per-iter", type=int, default=3000)
    p.add_argument("--sci-max-basis", type=int, default=300_000,
                   help="with --sci: variational basis cap (the deep "
                        "Heisenberg-24 record used 600k)")
    p.add_argument("--sci-growth", type=float, default=0.0,
                   help="with --sci: SHCI-style proportional adds — each "
                        "round adds max(per-iter, growth * basis) states")
    p.add_argument("--sci-threshold", type=float, default=1e-4,
                   help="with --sci: PT2 coupling threshold — candidates "
                        "with |<i|H|Phi>| below it are never added; the "
                        "deep records self-terminate at this cutoff")
    p.add_argument("--sci-screen", type=float, default=0.0,
                   help="SHCI source screening factor: skip scoring rows "
                        "with |c_j|*Hmax < screen*threshold (0 = off)")
    p.add_argument("--sci-pt2-cap", type=int, default=0,
                   help="with --sci: external-row fetch cap for the exact "
                        "PT2 correction (0 = default 2^23; raise when "
                        "pt2_exact comes back False)")
    p.add_argument("--sci-sort-rows", type=int, default=0,
                   help="with --sci: pre-sort row cap for the device PT2 "
                        "scorer — keep only the top-N rows by |c_j*H_ij| "
                        "(an exact top-k) before the sort (SHCI per-row "
                        "screen).  0 = off")
    p.add_argument("--exact-full", action="store_true",
                   help="with --system large: EXACT full-2^n ground state "
                        "on one chip (identity-ELL device Lanczos + host "
                        "f64 refine), cross-checked vs the independent "
                        "oracle")
    p.add_argument("--sci-depth", action="store_true",
                   help="with --pipeline: apply --sci-iters/--sci-per-iter "
                        "as stage-3 depth overrides (post-tier)")
    # back-compat with the round-1 CLI
    p.add_argument("--model", dest="system_alias", default=None,
                   choices=["tfim", "heisenberg", "heisenberg-hx"])
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = args.device
    if args.scan:
        system = "convergence"
    elif args.system == "large":
        system = "large"            # --model selects the lattice type
    else:
        system = args.system_alias or args.system

    if system in ("tfim", "all"):
        run_three_mode_experiment("tfim", args.spins, args.h,
                                  args.krylov_dim, args.shots, args.epochs,
                                  device=dev)
    if system in ("heisenberg", "all"):
        h = args.h if system == "heisenberg" else 0.1
        run_three_mode_experiment("heisenberg", args.spins, h,
                                  args.krylov_dim, args.shots, args.epochs,
                                  device=dev)
    if system in ("convergence", "all"):
        # reference experiment 3 runs at krylov dim 15 (``:452-456``)
        run_convergence_scan(args.spins, max(args.krylov_dim, 15),
                             args.shots, device=dev)
    if system in ("discovery", "all"):
        run_discovery_comparison(args.spins, args.h, args.krylov_dim,
                                 args.shots, args.epochs, device=dev)
    if system == "large":
        if args.exact_full:
            run_exact_fullspace(args.system_alias or "tfim",
                                args.spins, args.h, device=dev)
        elif args.sci:
            run_large_spin_sci(args.system_alias or "heisenberg",
                               args.spins, args.h, iters=args.sci_iters,
                               per_iter=args.sci_per_iter,
                               max_basis=args.sci_max_basis,
                               growth=args.sci_growth,
                               pt2_cap=args.sci_pt2_cap,
                               threshold=args.sci_threshold,
                               screen=args.sci_screen,
                               sort_rows=args.sci_sort_rows, device=dev)
        elif args.study:
            points = None
            if args.study_points:
                points = [(int(k), int(s), float(dt))
                          for k, s, dt in (pt.split(",")
                                           for pt in
                                           args.study_points.split(";"))]
            run_large_convergence_study(args.spins, args.h, points=points,
                                        device=dev)
        elif args.pipeline:
            run_large_spin_pipeline(args.system_alias or "heisenberg",
                                    args.spins, args.h, args.krylov_dim,
                                    args.shots, args.epochs,
                                    sci_iters=args.sci_iters if args.sci_depth
                                    else 0,
                                    sci_per_iter=args.sci_per_iter
                                    if args.sci_depth else 0,
                                    sci_growth=args.sci_growth
                                    if args.sci_depth else 0.0,
                                    device=dev)
        else:
            run_large_spin(args.spins, args.h, args.krylov_dim, args.shots,
                           model=args.system_alias or "tfim", device=dev)


if __name__ == "__main__":
    main()
