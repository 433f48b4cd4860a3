"""Solve runner: one whole four-stage pipeline a solve.

A solve is ``FlowGuidedKrylovPipeline(h, PipelineConfig(**settings,
seed=s), exact_energy=E_FCI).run()`` on a molecule whose integrals and
FCI energy the benchmark hands to the program (the CLI ``benchmark
--molecule <m>`` passes the exact energy the same way, so the stage-4
skip rules match the record's).  From the timed path the runner keeps the
first stage-1 step's inputs and outputs (the NQS parameters before it,
its sampled configurations, its reported energy and the optimizer's
first moments after it), the stage-2 basis, and the stage-3 basis and
energies.  The check, in float64 with ``perfbench/reference/``, replays
that first step's NQS half, solves the stage-2 and stage-3 bases again,
and holds the answer against the reference's FCI energy.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time
from unittest import mock

import numpy as np

from perfbench import tracing
from perfbench.reference import slater

# faults the benchmark's own tests and readings plant in the timed path
FAULTS = ("answer", "unchanged", "frozen", "half")


class Cell:
    def __init__(self, spec, device, seed, trace, fault, cache):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: this cell has {FAULTS}")
        self.spec = spec
        self.conf = spec.config
        self.settings = dict(spec.config["pipeline"])
        self.device = device
        self.trace = trace
        self.fault = fault
        self.cache = cache
        self.h = None
        self._H_all = None

    # -- inputs -----------------------------------------------------------

    def _integrals_path(self):
        from perfbench.run import REPO
        return REPO / self.conf["integrals"]

    def fci_energy(self, H=None) -> float:
        """The reference's FCI energy of the integrals file, cached under
        the benchmark's cache directory by the file's hash; ``H`` is the
        Hamiltonian over every determinant, when already built."""
        path = self._integrals_path()
        digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
        store = self.cache / f"fci-{digest}.json"
        try:
            return float(json.loads(store.read_text())["fci_energy"])
        except (OSError, ValueError, KeyError):
            pass
        if H is None:
            H = self._full_hamiltonian()[1]
        e = slater.ground_energy(H)
        store.write_text(json.dumps({"fci_energy": e}))
        return e

    def _full_hamiltonian(self):
        """Every determinant and H over them, built once a run."""
        if self._H_all is not None:
            return self._H_all
        c = self.conf
        h1, h2, e_nuc = slater.load_integrals(str(self._integrals_path()))
        dets = slater.all_determinants(c["n_orbitals"], c["n_alpha"],
                                       c["n_beta"])
        self._H_all = dets, slater.projected_hamiltonian(
            dets, c["n_orbitals"], c["n_alpha"], c["n_beta"], h1, h2, e_nuc)
        return self._H_all

    def setup(self):
        from flow_guided_krylov_torch.chem.scf import MolecularIntegrals
        from flow_guided_krylov_torch.hamiltonians.molecular import \
            MolecularHamiltonian
        c = self.conf
        h1, h2, e_nuc = slater.load_integrals(str(self._integrals_path()))
        # the exact energy the program is handed; the check holds it to the
        # reference's, which it works out after the window
        self.fci = float(c["fci_energy"])
        ints = MolecularIntegrals(
            h1e=h1, h2e=h2, nuclear_repulsion=e_nuc,
            n_electrons=c["n_alpha"] + c["n_beta"],
            n_orbitals=c["n_orbitals"], n_alpha=c["n_alpha"],
            n_beta=c["n_beta"])
        self.h = MolecularHamiltonian(ints, self.device)
        # warm-up: the cell's own shapes, a few epochs and one round
        warm = self.spec.traffic["warmup"]
        self._run(0, epochs=warm["epochs"], rounds=warm["stage3_rounds"])

    # -- a solve ----------------------------------------------------------

    def _pipeline(self, seed):
        from flow_guided_krylov_torch.pipeline import (
            FlowGuidedKrylovPipeline, PipelineConfig)
        cfg = PipelineConfig(seed=seed, verbose=False, **self.settings)
        pipe = FlowGuidedKrylovPipeline(self.h, cfg, exact_energy=self.fci)
        as_run = {k: getattr(pipe.config, k) for k in self.settings}
        if as_run != self.settings:
            raise RuntimeError(f"the program ran {as_run}, not the "
                               f"configuration's {self.settings}")
        return pipe

    def _run(self, seed, epochs=None, rounds=None, traced=False):
        import torch
        from flow_guided_krylov_torch.flows import \
            physics_guided_training as pgt
        from flow_guided_krylov_torch.krylov.residual_expansion import \
            SelectedCIExpander
        from flow_guided_krylov_torch.krylov.skqd import \
            SampleBasedKrylovDiagonalization
        pipe = self._pipeline(seed)
        if epochs is not None:
            pipe.config.max_epochs = epochs
            pipe.config.min_epochs = min(epochs, pipe.config.min_epochs)
            pipe.config.residual_iterations = rounds
        fault = self.fault if epochs is None else None
        eig = tracing.HostEigensolves()
        step1 = {}
        update = pgt.PhysicsGuidedFlowTrainer.update

        def update_kept(trainer, configs, priorities=None):
            first = not step1
            if first:
                before = [(k, v.detach().clone())
                          for k, v in trainer.nqs.named_parameters()]
                sampled = configs.detach().to(torch.uint8)
            if fault == "half":
                configs = configs[:len(configs) // 2]
            out = update(trainer, configs, priorities)
            if first:
                opt = trainer.nqs_opt
                step1.update(
                    params={k: v.cpu().numpy() for k, v in before},
                    configs=sampled.cpu().numpy(),
                    energy=float(out[0]),
                    # a copy: on the host .numpy() shares the moments
                    mu={k: m.detach().cpu().numpy().copy()
                        for (k, _), m in zip(before, opt.mu)},
                    b1=float(opt.b1), max_norm=float(opt.max_norm))
            return out

        patches = [mock.patch.object(pgt.PhysicsGuidedFlowTrainer, "update",
                                     update_kept)]
        if traced:
            for stage in ("train_flow_nqs", "extract_and_select_basis",
                          "run_residual_expansion", "run_skqd"):
                patches.append(mock.patch.object(
                    pipe, stage, _spanned(stage, getattr(pipe, stage))))
        if fault == "frozen":
            # every optimizer step returns its state unchanged
            patches.append(mock.patch.object(pgt.OptaxAdamW, "step",
                                             lambda opt, grads: None))
        elif fault in ("answer", "unchanged"):
            patches.append(mock.patch.object(
                SelectedCIExpander, "expand_basis",
                _broken_expand(SelectedCIExpander.expand_basis, fault)))
            if fault == "unchanged":
                patches.append(mock.patch.object(
                    SampleBasedKrylovDiagonalization, "evolve",
                    lambda obj, psi: psi))
        t0 = time.perf_counter()
        with eig.patched(), contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            out = pipe.run()
        wall = time.perf_counter() - t0
        st3 = pipe.results["stage3"]
        trainer = pipe.trainer
        record = {
            "seed": seed,
            "energy": float(out["final_energy"]),
            "stage3_energy": float(st3["energy"]),
            "basis": np.asarray(st3["basis"], np.int64),
            "stage2_basis": np.asarray(pipe.nf_basis, np.int64),
            "step1": step1,
            "stage4_skipped": bool(pipe.results["stage4"].get("skipped")),
            "wall_s": wall,
            "stage_s": {k: v for k, v in pipe.timer.spans.items()},
            "epoch_s": list(trainer.history["epoch_times"]),
            "accumulated_energy_s": list(trainer.accumulated_energy_times),
            "host_eigensolve_s": eig.seconds,
            "route": trainer.route,
            "n_valid": int(pipe.n_valid),
            "batch": int(pipe.config.samples_per_batch),
            "nqs_widths": [2 * self.h.n_orbitals]
            + list(pipe.config.nqs_hidden_dims) + [1],
            "flow": _flow_widths(pipe.flow),
        }
        del pipe, trainer
        return record

    def solve(self, seed, traced=False):
        return self._run(seed, traced=traced)

    def release(self):
        import torch
        self.h = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def check(self, records, seed, control=False):
        """The numbers compared, each with its limit."""
        from perfbench.reference import nqs
        c = self.conf
        n, na, nb = c["n_orbitals"], c["n_alpha"], c["n_beta"]
        h1, h2, e_nuc = slater.load_integrals(str(self._integrals_path()))
        lim = self.spec.limits
        dets, H_all = self._full_hamiltonian()
        fci = self.fci_energy(H_all)
        # the exact energy handed to the program is the reference's own
        bad = int(abs(self.fci - fci) > 1e-9)
        published = c.get("fci_energy_published")
        if published is not None and abs(fci - published) > 1e-6:
            bad += 1

        def solved(basis, precise=True):
            H = slater.projected_hamiltonian(basis, n, na, nb, h1, h2, e_nuc)
            return slater.ground_energy(H, np.float64 if precise
                                        else np.float32), H

        gap, gap2, worst = 0.0, -np.inf, -np.inf
        e1_gap, g1_gap = 0.0, 0.0
        for r in records:
            for basis in (r["basis"], r["stage2_basis"]):
                bad += slater.basis_problems(basis, n, na, nb)
            # stage 3: the reported energy of the reported basis
            e_ref, H = solved(r["basis"])
            # the control: the reference, in float32, in the program's place
            e_prog = (slater.ground_energy(H, np.float32) if control
                      else r["stage3_energy"])
            gap = max(gap, abs(e_prog - e_ref))
            final = e_prog if control else r["energy"]
            # the final energy is the stage-3 one or, after stage 4, lower
            if not control and final > r["stage3_energy"] + 1e-12:
                bad += 1
            worst = max(worst, 1000.0 * (final - fci))
            # stage 2: the basis that stage 1's samples and NQS selected
            e2 = solved(r["stage2_basis"], not control)[0]
            gap2 = max(gap2, 1000.0 * (e2 - fci))
            # stage 1: its first step's NQS half, replayed from the
            # program's parameters before it and its sampled rows
            s1 = r["step1"]
            e1, norms = nqs.first_step(s1["params"], s1["configs"], dets,
                                       H_all, n, s1["max_norm"],
                                       self.device)
            if control:
                e_p, norms_p = nqs.first_step(
                    s1["params"], s1["configs"], dets, H_all, n,
                    s1["max_norm"], self.device, tf32=True)
            else:
                e_p = s1["energy"]
                # the clipped gradient the optimizer was handed: its first
                # moment after one step is (1 - b1) times it
                norms_p = {k: float(np.linalg.norm(
                    np.asarray(m, np.float64))) / (1.0 - s1["b1"])
                    for k, m in s1["mu"].items()}
            e1_gap = max(e1_gap, abs(e_p - e1))
            floor = float(np.median(list(norms.values())))
            g1_gap = max(g1_gap, max(
                abs(norms_p[k] - v) / max(v, floor) for k, v in norms.items()))
        if not records:
            worst = gap2 = np.inf
        return {
            "step1_energy_gap_ha": {"value": e1_gap,
                                    "limit": lim["step1_energy_gap_ha"]},
            "step1_grad_gap": {"value": g1_gap,
                               "limit": lim["step1_grad_gap"]},
            "stage2_gap_mha": {"value": float(gap2),
                               "limit": lim["stage2_gap_mha"]},
            "energy_gap_ha": {"value": gap,
                              "limit": lim["energy_gap_ha"]},
            "fci_gap_mha": {"value": float(worst),
                            "limit": lim["fci_gap_mha"]},
            "problems": {"value": bad, "limit": 0},
        }


def _flow_widths(flow):
    """(in, out) of each linear layer of the flow."""
    import torch
    return [[m.in_features, m.out_features] for m in flow.modules()
            if isinstance(m, torch.nn.Linear)]


def _spanned(name, fn):
    def call(*args, **kw):
        with tracing.span(name):
            return fn(*args, **kw)
    return call


def _broken_expand(expand, fault):
    """``expand_basis`` with a planted fault: ``answer`` reports an energy
    1e-6 Ha off; ``unchanged`` returns its input basis, never grown (and
    the stage-4 evolve, patched beside it, returns its state)."""
    def call(self, basis, *args, **kw):
        out = expand(self, basis, *args, **kw)
        if fault == "answer":
            out = dict(out, energy=out["energy"] + 1e-6)
        elif fault == "unchanged":
            e, _ = self._diagonalize(basis)
            out = dict(out, basis=basis, energy=e, n_added=0)
        return out
    return call
