"""Solve runner: one Trotter SKQD study a solve on a spin chain.

A solve is ``examples/skqd_lattice_validation.py::run_pure_skqd(h,
|0...0>, K, shots, seed=s, time_step=dt, final_only=True)``: K Krylov
steps of 2^n amplitudes through the x_sweep kernel, K draws of ``shots``
configurations and one host eigensolve on their union.  The benchmark
keeps, from the timed path itself, the amplitudes of every evolved state
at a fixed set of configurations (all of Hamming weight up to 3, and
more drawn from the run's seed), every step's draw counts and the
reported basis and energy.  The check, with ``perfbench/reference/tfim.py``
in float64, evolves the same states, compares the amplitudes, holds each
draw's Hamming-weight histogram to the reference's probabilities (a chi^2
over classes), counts the shots, and solves the reported basis again.
"""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import numpy as np

from perfbench import tracing
from perfbench.reference import tfim
from perfbench.reference.eig import ground_energy

FAULTS = ("answer", "unchanged", "half", "token")
MIN_EXPECTED = 20.0     # smallest expected count of a chi^2 class


class Cell:
    def __init__(self, spec, device, seed, trace, fault, cache):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: this cell has {FAULTS}")
        c = spec.config
        self.spec = spec
        self.n, self.V, self.hx = c["n_sites"], c["V"], c["h"]
        self.K, self.shots, self.dt = (c["krylov_dim"], c["shots"],
                                       c["time_step"])
        self.substeps = c["trotter_substeps"]
        self.evolution = c["evolution"]
        self.device = device
        self.seed = seed
        self.trace = trace
        self.fault = fault
        self.h = None

    def setup(self):
        import torch
        from flow_guided_krylov_torch.hamiltonians import TransverseFieldIsing
        from flow_guided_krylov_torch.hamiltonians.spin import \
            pack_spin_state
        n = self.n
        self.exact = tfim.free_fermion_energy(n, self.V, self.hx)
        self.h = TransverseFieldIsing(n, V=self.V, h=self.hx,
                                      periodic=True, device=self.device)
        self.init = pack_spin_state(0, n)
        # the configurations whose amplitudes the check compares
        low = [0] + [1 << i for i in range(n)]
        low += [(1 << i) | (1 << j) for i in range(n) for j in range(i)]
        low += [(1 << i) | (1 << j) | (1 << k) for i in range(n)
                for j in range(i) for k in range(j)]
        rng = np.random.default_rng(self.seed)
        extra = rng.integers(0, 1 << n, self.spec.traffic["random_probes"])
        self.probes = np.unique(np.concatenate([low, extra]))
        self.probes_dev = torch.as_tensor(self.probes, device=self.device)
        # warm-up: one draw, one evolve and a draw of the cell's size
        self._run(0, krylov_dim=2)

    def _run(self, seed, krylov_dim=None):
        import torch
        from flow_guided_krylov_torch.examples.skqd_lattice_validation \
            import run_pure_skqd
        from flow_guided_krylov_torch.krylov import skqd as skqd_mod
        Skqd = skqd_mod.SampleBasedKrylovDiagonalization
        amps, draws, evolve_s = [], [], []
        probes = self.probes_dev
        evolve = Skqd._evolve_trotter
        sync = self.trace and self.device.type == "cuda"
        fault = self.fault if krylov_dim is None else None

        def evolve_kept(obj, re, im):
            if sync:
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            with tracing.span("evolve"):
                if fault == "unchanged":
                    out = (re, im)
                else:
                    out = evolve(obj, re, im)
            if sync:
                torch.cuda.synchronize(self.device)
            evolve_s.append(time.perf_counter() - t0)
            amps.append((out[0][probes], out[1][probes]))
            return out

        build = Skqd.build_cumulative_basis

        def basis_kept(obj, samples):
            draws.extend(samples)
            with tracing.span("basis"):
                return build(obj, samples)

        sample = skqd_mod._sample_idx_cdf

        def sample_broken(prob, uniforms):
            idx = sample(prob, uniforms)
            if fault == "half":
                idx = idx[:len(idx) // 2]
            else:
                # "token": 2 % of the draws, one site flipped
                g = torch.Generator(device=idx.device).manual_seed(1)
                hit = torch.rand(idx.shape, generator=g,
                                 device=idx.device) < 0.02
                site = torch.randint(0, self.n, idx.shape, generator=g,
                                     device=idx.device)
                idx = torch.where(hit, idx ^ (1 << site), idx)
            return idx

        solve_energy = Skqd.compute_ground_state_energy

        def energy_broken(obj, basis, *args, **kw):
            return solve_energy(obj, basis, *args, **kw) + 1e-6

        patches = [mock.patch.object(Skqd, "_evolve_trotter", evolve_kept),
                   mock.patch.object(Skqd, "build_cumulative_basis",
                                     basis_kept)]
        # the planted faults patch two more names, for their runs only
        if fault in ("half", "token"):
            patches.append(mock.patch.object(skqd_mod, "_sample_idx_cdf",
                                             sample_broken))
        elif fault == "answer":
            patches.append(mock.patch.object(
                Skqd, "compute_ground_state_energy", energy_broken))
        eig = tracing.HostEigensolves()
        t0 = time.perf_counter()
        with eig.patched(), contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            out = run_pure_skqd(self.h, self.init,
                                krylov_dim or self.K, self.shots,
                                seed=seed, time_step=self.dt,
                                evolution=self.evolution, final_only=True)
        wall = time.perf_counter() - t0
        if not out["trotter"]:
            raise RuntimeError("the solve left the Trotter path")
        return {
            "seed": seed,
            "energy": float(out["energy"]),
            "basis": np.asarray(out["basis"], np.int64).reshape(-1),
            "draws": [(np.fromiter(d.keys(), np.int64, len(d)),
                       np.fromiter(d.values(), np.int64, len(d)))
                      for d in draws],
            "amps": [(re.double().cpu().numpy(), im.double().cpu().numpy())
                     for re, im in amps],
            "evolve_s": evolve_s,
            "host_eigensolve_s": eig.seconds,
            "wall_s": wall,
            "substeps": len(evolve_s) * self.substeps,
        }

    def solve(self, seed, traced=False):
        # the spans are always open: a few dozen a solve
        return self._run(seed)

    def release(self):
        import torch
        self.h = None
        self.probes_dev = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def check(self, records, seed, control=False):
        """The numbers compared, each with its limit."""
        import torch
        lim = self.spec.limits
        n, shots = self.n, self.shots
        shots_gap = 0
        for r in records:
            for _, counts in r["draws"]:
                shots_gap = max(shots_gap, abs(int(counts.sum()) - shots))
            if len(r["draws"]) != self.K or len(r["amps"]) != self.K - 1:
                shots_gap = max(shots_gap, shots)

        # the reference's states, once: every solve starts from |0...0>
        weights = None
        probes = torch.as_tensor(self.probes, device=self.device)
        ref_amps, ref_weights, ctl_amps = [], [], []
        states = tfim.krylov_states(n, self.V, self.hx, self.dt,
                                    self.substeps, self.K - 1, self.device)
        ctl = (tfim.krylov_states(n, self.V, self.hx, self.dt,
                                  self.substeps, self.K - 1, self.device,
                                  dtype=torch.bfloat16)
               if control else None)
        for k, re, im in states:
            if weights is None:
                weights = tfim.popcount(torch.arange(
                    1 << n, device=self.device), n)
            ref_amps.append((re[probes].cpu().numpy(),
                             im[probes].cpu().numpy()))
            ref_weights.append(tfim.weight_probabilities(re, im, weights,
                                                         n))
            del re, im
            if ctl is not None:
                _, cre, cim = next(ctl)
                ctl_amps.append((cre[probes].double().cpu().numpy(),
                                 cim[probes].double().cpu().numpy()))
                del cre, cim
        del weights, states, ctl

        state_gap = 0.0
        for amps in ([ctl_amps] if control else
                     [r["amps"] for r in records]):
            for (pr, pi), (rr, ri) in zip(amps, ref_amps):
                state_gap = max(state_gap, float(np.max(np.hypot(
                    pr - rr, pi - ri))))

        chi2 = 0.0
        for r in records:
            for k, (keys, counts) in enumerate(r["draws"][1:], 1):
                if k - 1 >= len(ref_weights):
                    break
                obs = np.bincount(tfim._popcount_np(keys), weights=counts,
                                  minlength=n + 1)
                chi2 = max(chi2, _chi2_z(obs, shots * ref_weights[k - 1]))

        # the reported energies, on a sample drawn from the run's seed
        rng = np.random.default_rng(seed)
        take = rng.permutation(len(records))[
            :self.spec.traffic["energy_checks"]]
        energy_gap = 0.0
        for i in take:
            r = records[i]
            H = tfim.projected_hamiltonian(r["basis"], n, self.V, self.hx)
            e_ref = ground_energy(H)
            e_prog = ground_energy(H, np.float32) if control else r["energy"]
            energy_gap = max(energy_gap, abs(e_prog - e_ref))
        return {
            "state_gap": {"value": state_gap, "limit": lim["state_gap"]},
            "energy_gap_ha": {"value": energy_gap,
                              "limit": lim["energy_gap_ha"]},
            "weight_chi2_z": {"value": chi2, "limit": lim["weight_chi2_z"]},
            "shots_gap": {"value": shots_gap, "limit": 0},
        }


def _chi2_z(obs: np.ndarray, expected: np.ndarray) -> float:
    """Pearson chi^2 of observed against expected counts, over classes of
    adjacent Hamming weights merged until each expects MIN_EXPECTED or
    more, as a z-score: (chi^2 - dof) / sqrt(2 dof)."""
    o_cls, e_cls = [], []
    o_acc = e_acc = 0.0
    for o, e in zip(obs, expected):
        o_acc += o
        e_acc += e
        if e_acc >= MIN_EXPECTED:
            o_cls.append(o_acc)
            e_cls.append(e_acc)
            o_acc = e_acc = 0.0
    if e_cls:
        o_cls[-1] += o_acc
        e_cls[-1] += e_acc
    o_cls, e_cls = np.array(o_cls), np.array(e_cls)
    dof = len(e_cls) - 1
    if dof < 1:
        return 0.0
    chi2 = float(np.sum((o_cls - e_cls) ** 2 / e_cls))
    return (chi2 - dof) / np.sqrt(2.0 * dof)
