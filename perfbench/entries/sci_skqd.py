"""Solve runner: one Selected-CI round, its exact dE2 and restricted SKQD
through the ELL kernel, a solve, on a molecule past full-space
enumeration.

A solve is what ``large_system_benchmark --mode sci+skqd`` runs:
``run_sci(h, None, iters=..., per_iter=..., threshold=...)`` (HF-seeded
Selected-CI and the exact Epstein-Nesbet dE2 of its state), then
``run_restricted_skqd(h, None, basis, E_var, krylov_dim, shots, dt,
seed=s)``: ``supported_evolution_dim`` sizes the cap,
``build_restricted_subspace`` fills it with the SCI basis and its top
PT2-ranked externals, and ``evolve`` (``auto``) takes the ELL Lanczos
propagator, whose tables the solve builds on the device.  The
Hamiltonian is built once, in set-up, from the configuration's
integrals; every solve builds its own subspace, tables and SKQD state.

From the timed path the runner keeps E_var, dE2 and the SCI basis, the
cap and the restricted set, every evolved state (the host vectors
``evolve`` returns), every draw, the combined basis and the reported
energy.  The check, with ``perfbench/reference/restricted.py`` in
float64, solves the SCI basis again, sums its dE2 over every external,
ranks the externals, evolves the same states on the same restricted set
and compares all their amplitudes, holds each draw's histogram by
excitation rank to the reference's probabilities (a chi^2 over ranks),
and solves the reported combined basis again (``reference/slater.py``).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from unittest import mock

import numpy as np

from perfbench.entries.trotter_skqd import _chi2_z
from perfbench.reference import restricted, slater
from perfbench.reference.eig import ground_energy

# faults the benchmark's own tests and readings plant in the timed path
FAULTS = ("answer", "unchanged", "half", "tables")
TABLE_FAULT = 1.01      # the ``tables`` fault scales every ELL element


class Cell:
    def __init__(self, spec, device, seed, trace, fault, cache):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: this cell has {FAULTS}")
        self.spec = spec
        self.conf = spec.config
        self.device = device
        self.trace = trace
        self.fault = fault
        self.h = None

    def _integrals_path(self):
        from perfbench.run import REPO
        return REPO / self.conf["integrals"]

    def setup(self):
        from flow_guided_krylov_torch.chem.scf import MolecularIntegrals
        from flow_guided_krylov_torch.hamiltonians.molecular import \
            MolecularHamiltonian
        c = self.conf
        h1, h2, e_nuc = slater.load_integrals(str(self._integrals_path()))
        ints = MolecularIntegrals(
            h1e=h1, h2e=h2, nuclear_repulsion=e_nuc,
            n_electrons=c["n_alpha"] + c["n_beta"],
            n_orbitals=c["n_orbitals"], n_alpha=c["n_alpha"],
            n_beta=c["n_beta"])
        self.h = MolecularHamiltonian(ints, self.device)
        # warm-up: one whole solve, the cell's own shapes
        self._run(0, warm=True)

    # -- a solve ----------------------------------------------------------

    def _run(self, seed, warm=False):
        from flow_guided_krylov_torch.examples import \
            large_system_benchmark as lsb
        from flow_guided_krylov_torch.krylov import skqd as skqd_mod
        Skqd = skqd_mod.SampleBasedKrylovDiagonalization
        Flow = skqd_mod.FlowGuidedSKQD
        s, q = self.conf["sci"], self.conf["skqd"]
        fault = None if warm else self.fault
        kept = {"states": [], "draws": [], "ell_evolves": 0}

        build = lsb.build_restricted_subspace

        def restrict_kept(h, basis, cap, initial_state=None, mesh=None):
            states = build(h, basis, cap, initial_state=initial_state,
                           mesh=mesh)
            kept.update(cap=int(cap),
                        restricted=np.asarray(states, np.int64),
                        init=np.atleast_2d(np.asarray(initial_state,
                                                      np.int64)))
            return states

        evolve = Skqd.evolve

        def evolve_kept(obj, psi):
            out = psi if fault == "unchanged" else evolve(obj, psi)
            kept["states"].append(out)
            return out

        ell = Skqd._evolve_device_ell

        def ell_counted(obj, psi):
            kept["ell_evolves"] += 1
            return ell(obj, psi)

        cumulative = Skqd.build_cumulative_basis

        def draws_kept(obj, samples):
            kept["draws"] = [(np.fromiter(d.keys(), np.int64, len(d)),
                              np.fromiter(d.values(), np.int64, len(d)))
                             for d in samples]
            return cumulative(obj, samples)

        combine = Flow.get_combined_basis

        def combined_kept(obj, krylov_basis):
            out = combine(obj, krylov_basis)
            kept["combined"] = np.asarray(out, np.int64)
            return out

        patches = [
            mock.patch.object(lsb, "build_restricted_subspace",
                              restrict_kept),
            mock.patch.object(Skqd, "evolve", evolve_kept),
            mock.patch.object(Skqd, "_evolve_device_ell", ell_counted),
            mock.patch.object(Skqd, "build_cumulative_basis", draws_kept),
            mock.patch.object(Flow, "get_combined_basis", combined_kept)]
        # the planted faults patch one more name, for their runs only
        if fault == "half":
            sample = skqd_mod._sample_idx_cdf

            def half_drawn(prob, uniforms):
                idx = sample(prob, uniforms)
                return idx[:len(idx) // 2]
            patches.append(mock.patch.object(skqd_mod, "_sample_idx_cdf",
                                             half_drawn))
        elif fault == "answer":
            solve_energy = Flow.compute_ground_state_energy

            def energy_broken(obj, basis, *args, **kw):
                return solve_energy(obj, basis, *args, **kw) + 1e-6
            patches.append(mock.patch.object(
                Flow, "compute_ground_state_energy", energy_broken))
        elif fault == "tables":
            tables = Skqd._build_ell_device

            def tables_broken(obj, *args, **kw):
                diag, elems, tgt = tables(obj, *args, **kw)
                return diag, elems * TABLE_FAULT, tgt
            patches.append(mock.patch.object(Skqd, "_build_ell_device",
                                             tables_broken))
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            sci = lsb.run_sci(self.h, None, iters=s["iters"],
                              per_iter=s["per_iter"],
                              threshold=s["threshold"])
            basis = sci.pop("_basis")
            out = lsb.run_restricted_skqd(
                self.h, None, basis, sci["final_energy"],
                krylov_dim=q["krylov_dim"], shots=q["shots"],
                dt=q["time_step"], seed=seed)
        wall = time.perf_counter() - t0
        if (fault != "unchanged" and self.conf["route"] == "ell"
                and kept["ell_evolves"] != q["krylov_dim"] - 1):
            raise RuntimeError(f"{kept['ell_evolves']} evolves took the "
                               "ELL route, not every one")
        return {
            "seed": seed,
            "e_var": float(sci["final_energy"]),
            "de2": float(sci["pt2_de2"]),
            "pt2_exact": bool(sci["pt2_exact"]),
            "sci_basis": np.asarray(basis, np.int64),
            "cap": kept["cap"],
            "init": kept["init"],
            "restricted": kept["restricted"],
            "restricted_dim": int(out["skqd_restricted_dim"]),
            "states": kept["states"],
            "draws": kept["draws"],
            "combined": kept["combined"],
            "energy": float(out["skqd_energy"]),
            "improvement_mha": float(out["skqd_improvement_mha"]),
            "wall_s": wall,
        }

    def solve(self, seed, traced=False):
        return self._run(seed)

    def release(self):
        import torch
        self.h = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def check(self, records, seed, control=False):
        """The numbers compared, each with its limit."""
        import torch
        c, lim = self.conf, self.spec.limits
        rec = c["record"]
        n, na, nb = c["n_orbitals"], c["n_alpha"], c["n_beta"]
        K, shots = c["skqd"]["krylov_dim"], c["skqd"]["shots"]
        h1, h2, e_nuc = slater.load_integrals(str(self._integrals_path()))
        ints = restricted.Integrals(h1, h2, e_nuc, na, nb, self.device)
        hf = np.array([(1 << na) - 1, (1 << nb) - 1], np.int64)
        bf16 = torch.bfloat16

        # the SCI basis: its float64 energy, dE2 and ranked externals
        sci = {}
        bad, sci_gap, de2_gap = 0, 0.0, 0.0
        for r in records:
            for b in (r["sci_basis"], r["restricted"], r["combined"]):
                bad += slater.basis_problems(b, n, na, nb)
            key = r["sci_basis"].tobytes()
            if key not in sci:
                H, _ = restricted.hamiltonian(ints, r["sci_basis"])
                e, v = restricted.ground_state(H)
                p = restricted.pt2(ints, r["sci_basis"], v, e)
                e_ctl = de2_ctl = None
                if control:
                    e_ctl = ground_energy(slater.projected_hamiltonian(
                        r["sci_basis"], n, na, nb, h1, h2, e_nuc),
                        np.float32)
                    de2_ctl = restricted.pt2(ints, r["sci_basis"], v, e,
                                             dtype=bf16)["de2"]
                sci[key] = e, p, e_ctl, de2_ctl
                del H
            e, p, e_ctl, de2_ctl = sci[key]
            sci_gap = max(sci_gap, abs((e_ctl if control else r["e_var"])
                                       - e))
            de2_gap = max(de2_gap, abs((de2_ctl if control else r["de2"])
                                       - p["de2"]))
            # the record's numbers, and what the CLI reports of its run
            bad += int(abs(r["e_var"] - rec["e_var"]) > rec["tolerance_ha"])
            bad += int(abs(r["de2"] - rec["de2"]) > rec["tolerance_ha"])
            bad += int(not r["pt2_exact"])
            bad += int(len(r["sci_basis"]) != rec["sci_basis_size"])
            bad += int(r["restricted_dim"] != len(r["restricted"]))
            bad += restricted.restricted_problems(
                r["restricted"], r["sci_basis"], r["init"], r["cap"],
                p["externals"], p["scores"])
            bad += int(r["energy"] > r["e_var"] + 1e-12)
            bad += int(r["improvement_mha"]
                       < rec["skqd_improvement_floor_mha"])
            bad += int(len(r["draws"]) != K or len(r["states"]) != K - 1)
            bad += sum(int(counts.sum() != shots)
                       for _, counts in r["draws"])

        # the evolved states: one float64 chain a distinct restricted set
        refs = {}
        for r in records:
            key = r["restricted"].tobytes()
            if key not in refs:
                refs[key] = self._chain(ints, r["restricted"], hf, K,
                                        control)
        rng = np.random.default_rng(seed)
        take = rng.permutation(len(records))[
            :self.spec.traffic["energy_checks"]]
        state_gap = 0.0
        for i in take:
            r = records[i]
            ref, _, ctl = refs[r["restricted"].tobytes()]
            got = ctl if control else [x / np.linalg.norm(x)
                                       for x in r["states"]]
            for g, want in zip(got, ref):
                state_gap = max(state_gap, float(np.max(np.abs(g - want))))

        # each draw by excitation rank against the reference's |psi_k|^2
        chi2 = 0.0
        for r in records:
            _, probs, _ = refs[r["restricted"].tobytes()]
            ranks = restricted.excitation_rank(r["restricted"], hf)
            for k, (idx, counts) in enumerate(r["draws"][1:], 1):
                if k - 1 >= len(probs):
                    break
                obs = np.bincount(ranks[idx], weights=counts,
                                  minlength=na + nb + 1)
                chi2 = max(chi2, _chi2_z(obs, shots * probs[k - 1]))

        # the reported energy: the combined basis solved again
        energy_gap = 0.0
        for i in take:
            r = records[i]
            Hc = slater.projected_hamiltonian(r["combined"], n, na, nb, h1,
                                              h2, e_nuc)
            e_ref = ground_energy(Hc)
            e_prog = ground_energy(Hc, np.float32) if control else r[
                "energy"]
            energy_gap = max(energy_gap, abs(e_prog - e_ref))
        if not records:
            sci_gap = de2_gap = state_gap = energy_gap = np.inf
        else:
            print("sci-skqd readings: " + json.dumps({
                "e_var": sorted({r["e_var"] for r in records}),
                "de2": sorted({r["de2"] for r in records}),
                "sci_basis": sorted({len(r["sci_basis"]) for r in records}),
                "cap": sorted({r["cap"] for r in records}),
                "restricted": sorted({len(r["restricted"])
                                      for r in records}),
                "combined": [len(r["combined"]) for r in records],
                "improvement_mha": [r["improvement_mha"] for r in records],
                "energy": [r["energy"] for r in records],
                "traced_counters": _program_counters() if self.trace
                else None}), file=sys.stderr)
        return {
            "sci_energy_gap_ha": {"value": sci_gap,
                                  "limit": lim["sci_energy_gap_ha"]},
            "de2_gap_ha": {"value": de2_gap, "limit": lim["de2_gap_ha"]},
            "state_gap": {"value": state_gap, "limit": lim["state_gap"]},
            "weight_chi2_z": {"value": chi2, "limit": lim["weight_chi2_z"]},
            "energy_gap_ha": {"value": energy_gap,
                              "limit": lim["energy_gap_ha"]},
            "problems": {"value": bad, "limit": 0},
        }

    def _chain(self, ints, states, hf, K, control):
        """The reference's evolved states on ``states`` from HF (host
        complex vectors), their probabilities by excitation rank, and with
        ``control`` the bfloat16 chain's states."""
        import torch
        H, diag = restricted.hamiltonian(ints, states)
        key = (states[:, 0] << 32) | states[:, 1]
        start = int(np.flatnonzero(key == (int(hf[0]) << 32 | int(hf[1])))[0])
        ranks = torch.as_tensor(restricted.excitation_rank(states, hf),
                                device=ints.device)
        dt = self.conf["skqd"]["time_step"]
        n_ranks = ints.n_alpha + ints.n_beta + 1
        ref, probs, ctl = [], [], None
        for _, re, im in restricted.krylov_states(H, diag, start, K - 1,
                                                  dt):
            ref.append(re.cpu().numpy() + 1j * im.cpu().numpy())
            probs.append(restricted.rank_probabilities(re, im, ranks,
                                                       n_ranks))
        if control:
            ctl = [re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
                   for _, re, im in restricted.krylov_states(
                       H, diag, start, K - 1, dt, dtype=torch.bfloat16)]
        del H, diag
        return ref, probs, ctl


def _program_counters():
    """The program tracer's counters of the traced solve, or None where
    the program has none."""
    try:
        from flow_guided_krylov_torch.utils import profiling
        return profiling.snapshot()["counters"]
    except (ImportError, AttributeError):
        return None
