"""Four-stage Flow-Guided Krylov pipeline, molecular and spin.

Counterpart of ``flow_guided_krylov_tpu/pipeline.py``: the same
``PipelineConfig`` field names, defaults and size tiers, the same stage
methods and results-dict keys, on the Hamiltonian's device:

  Stage 1  flow + NQS co-training          (flows/physics_guided_training,
                                             flows/spin_training)
  Stage 2  diversity selection (molecules)  (postprocessing/diversity_selection)
           or top-|psi|^2 selection (spins)
  Stage 3  PT2 Selected-CI expansion        (krylov/residual_expansion)
  Stage 4  SKQD refinement + combination    (krylov/skqd)

A molecule trains the particle-conserving flow; a spin model that
conserves S_z trains the ``SzConservingFlow`` in the sector of its
lowest product state, any other spin model the ``DiscreteFlowSampler``.
Stage 4 evolves a molecule in its full or a restricted subspace, a spin
model in its sector (ELL) or as a 2^n statevector (Trotter).
Stage-3 early stopping (< 0.05 mHa improvement twice, best basis kept),
the stage-4 skip rules and the SKQD validation (energies below exact -
1 mHa are rejected) are the JAX package's.  ``use_local_energy=False``
trains stage 1 on the subspace energy (``flows/training.py``);
``checkpoint_dir`` saves the stage-1 trainer and the stage-2 and stage-3
results at their boundaries, and ``run(resume=True)`` restores stages 2
and 3 from them.  ``n_devices > 1`` (or a mesh set on ``pipeline.mesh``)
shards stage 1's trainer, stage 3's scorer and stage 4's SKQD over a
one-process device mesh (``parallel/``).  Branches not ported raise
``NotImplementedError`` naming their ROADMAP entry: three that fail in
the JAX package, the subspace-energy objective
(``use_local_energy=False``) together with checkpointing, the discrete
flow on a molecule (``use_particle_conserving_flow=False``) and multiword
configurations (more than 32 orbitals or 31 spins).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from math import comb
from typing import Dict, List, Optional

import numpy as np
import torch

from .flows.discrete import DiscreteFlowSampler
from .flows.particle_conserving import (ParticleConservingFlow,
                                        SzConservingFlow,
                                        verify_particle_conservation)
from .flows.physics_guided_training import (PhysicsGuidedConfig,
                                            PhysicsGuidedFlowTrainer)
from .flows.spin_training import SpinFlowTrainer
from .flows.training import FlowNQSTrainer, TrainingConfig
from .hamiltonians.molecular import MOLECULE_FACTORIES
from .krylov.residual_expansion import (ResidualExpansionConfig,
                                        SelectedCIExpander)
from .krylov.skqd import (FlowGuidedSKQD, SKQDConfig,
                          build_restricted_subspace, supported_evolution_dim)
from .models.dense import DenseNQS
from .ops.bits import unpack_np
from .postprocessing.diversity_selection import (DiversityConfig,
                                                 DiversitySelector)
from .utils.checkpoint import CheckpointManager
from .utils.memory import MemoryBudget
from .utils.profiling import StageTimer

__all__ = ["PipelineConfig", "FlowGuidedKrylovPipeline",
           "run_molecular_benchmark", "EnhancedFlowKrylovPipeline",
           "EnhancedPipelineConfig"]

MHA = 1e-3
CHEMICAL_ACCURACY = 1.6e-3  # 1 kcal/mol in Hartree
# the size tiers of ``PipelineConfig.adapt_to_system_size``: the largest
# configuration space of each, the JAX package's thresholds
_TIER_TOPS = (("small", 1000), ("medium", 5000), ("large", 20000),
              ("very_large", 500_000))


def size_tier(n_valid_configs: int) -> str:
    """The size tier ``PipelineConfig.adapt_to_system_size`` applies to a
    configuration space of ``n_valid_configs`` determinants or states."""
    for tier, top in _TIER_TOPS:
        if n_valid_configs <= top:
            return tier
    return "huge"


@dataclass
class PipelineConfig:
    """Pipeline knobs; the JAX package's field names and defaults."""

    # Flow type
    use_particle_conserving_flow: bool = True

    # NF-NQS architecture
    nf_hidden_dims: list = field(default_factory=lambda: [256, 256])
    nqs_hidden_dims: list = field(default_factory=lambda: [256, 256, 256, 256])

    # Training
    samples_per_batch: int = 2000
    num_batches: int = 1
    max_epochs: int = 400
    min_epochs: int = 100
    convergence_threshold: float = 0.20

    # Physics-guided loss weights
    teacher_weight: float = 0.5
    physics_weight: float = 0.4
    entropy_weight: float = 0.1

    # Learning rates
    nf_lr: float = 5e-4
    nqs_lr: float = 1e-3

    # Basis management
    max_accumulated_basis: int = 4096

    # Diversity selection
    use_diversity_selection: bool = True
    max_diverse_configs: int = 2048
    rank_2_fraction: float = 0.50

    # Residual expansion
    use_residual_expansion: bool = True
    residual_iterations: int = 8
    residual_configs_per_iter: int = 150
    residual_threshold: float = 1e-6
    use_perturbative_selection: bool = True
    # proportional adds (0 = fixed schedule): each stage-3 round adds
    # max(residual_configs_per_iter, f * basis) states
    residual_growth_factor: float = 0.0

    # SKQD
    max_krylov_dim: int = 8
    time_step: float = 0.1
    shots_per_krylov: int = 50_000
    skqd_regularization: float = 1e-8
    skip_skqd: bool = False

    # Training mode
    use_local_energy: bool = True
    use_ci_seeding: bool = False

    # Eigensolver: use_davidson routes the stage-3 warm eigensolves
    # (B > 2048) through preconditioned Davidson; davidson_threshold is
    # kept for config parity
    use_davidson: bool = True
    davidson_threshold: int = 500

    # Checkpointing: stage-boundary saves, ``run(resume=True)``
    checkpoint_dir: Optional[str] = None

    # Multi-device: more than one builds a ('data', 'basis') mesh (parallel/)
    n_devices: Optional[int] = None

    # Misc
    seed: int = 0
    verbose: bool = True

    def adapt_to_system_size(self, n_valid_configs: int) -> "PipelineConfig":
        """Tiered rescaling by configuration-space size (the JAX package's
        tiers and caps)."""
        tier = size_tier(n_valid_configs)
        if tier == "small":
            self.max_accumulated_basis = max(self.max_accumulated_basis,
                                             n_valid_configs)
            self.max_diverse_configs = min(n_valid_configs,
                                           self.max_diverse_configs)
        elif tier == "medium":
            self.max_accumulated_basis = min(n_valid_configs, 8192)
            self.max_diverse_configs = min(n_valid_configs, 4096)
            self.residual_iterations = max(self.residual_iterations, 10)
            self.residual_configs_per_iter = max(
                self.residual_configs_per_iter, 200)
            if len(self.nqs_hidden_dims) < 5:
                self.nqs_hidden_dims = [384] * 5
        elif tier == "large":
            self.max_accumulated_basis = min(n_valid_configs, 12288)
            self.max_diverse_configs = min(n_valid_configs, 8192)
            self.residual_iterations = 15
            self.residual_configs_per_iter = 300
            self.residual_threshold = 1e-7
            self.nqs_hidden_dims = [512] * 5
            self.max_epochs = max(self.max_epochs, 600)
            self.samples_per_batch = 4000
        elif tier == "very_large":
            self.max_accumulated_basis = 16384
            self.max_diverse_configs = min(n_valid_configs, 12288)
            self.residual_iterations = 20
            self.residual_configs_per_iter = 500
            self.residual_threshold = 1e-8
            self.nqs_hidden_dims = [512] * 6
            self.nf_hidden_dims = [384, 384]
            self.max_epochs = max(self.max_epochs, 800)
            self.min_epochs = max(self.min_epochs, 200)
            self.samples_per_batch = 6000
        else:
            # million-config spaces: stage 3 is the engine, so the
            # expansion budget must be deep, and stage-4 sampling needs
            # full-size shot budgets
            self.max_accumulated_basis = 32768
            self.max_diverse_configs = min(n_valid_configs, 16384)
            self.residual_iterations = 30
            self.residual_configs_per_iter = 2000
            self.residual_threshold = 1e-8
            self.nqs_hidden_dims = [512] * 6
            self.nf_hidden_dims = [384, 384]
            self.max_epochs = max(self.max_epochs, 800)
            self.min_epochs = max(self.min_epochs, 200)
            self.samples_per_batch = 6000
            self.max_krylov_dim = max(self.max_krylov_dim, 10)
            self.shots_per_krylov = max(self.shots_per_krylov, 100_000)
        if self.verbose:
            print(f"System size: {n_valid_configs:,} valid configs -> "
                  f"{tier} tier "
                  f"(basis cap {self.max_accumulated_basis:,}, "
                  f"diverse cap {self.max_diverse_configs:,})")
        return self


class FlowGuidedKrylovPipeline:
    """The four stages for molecular and spin Hamiltonians on
    ``hamiltonian.device``."""

    def __init__(self, hamiltonian, config: Optional[PipelineConfig] = None,
                 exact_energy: Optional[float] = None):
        self.h = hamiltonian
        self.config = config or PipelineConfig()
        self.exact_energy = exact_energy
        self.results: Dict = {}
        self.is_molecular = hasattr(hamiltonian, "n_alpha")
        c = self.config
        if hamiltonian.pack_words > (2 if self.is_molecular else 1):
            raise NotImplementedError(
                "the pipeline over multiword configurations (more than 32 "
                "orbitals or 31 spins) is not ported: the JAX package's own "
                "pipeline fails there (its stage-1 unique_compact "
                "broadcasts 4-word rows to 2 words, a ValueError; its "
                "_spin_reference_state_for packs 2^n - 1 into one uint32, an "
                "OverflowError); ROADMAP.md, Queue 1, item 2 remainder: the "
                "pipeline at W > 2")
        if self.is_molecular and not c.use_particle_conserving_flow:
            raise NotImplementedError(
                "use_particle_conserving_flow=False on a molecule is not "
                "ported: the JAX package's own branch fails there (its "
                "_spin_reference_state_for passes (3, 1) spin rows to "
                "MolecularHamiltonian.diagonal_np, a ValueError on H2); "
                "a fault of the reference, ROADMAP.md, Queue 3")
        if not c.use_local_energy and c.checkpoint_dir:
            raise NotImplementedError(
                "use_local_energy=False with checkpoint_dir is not ported: "
                "the JAX package's own run fails there (its "
                "CheckpointManager.save_trainer reads _acc_keys, which "
                "FlowNQSTrainer lacks: AttributeError: 'FlowNQSTrainer' "
                "object has no attribute '_acc_keys'); a fault of the "
                "reference, ROADMAP.md, Queue 3")
        self.device = hamiltonian.device
        # n_devices > 1: a ('data', 'basis') mesh for stage 1's trainer,
        # stage 3's expander and stage 4's SKQD, as in the JAX package;
        # ``cuda:0`` .. ``cuda:{n-1}`` for a Hamiltonian on a card (fewer
        # cards raise), n ``cpu`` entries for one on the CPU.  A mesh may
        # also be set on ``self.mesh`` before ``run()`` (a logical one:
        # ``make_mesh(n, devices=["cuda:0"] * n)``)
        self.mesh = None
        if c.n_devices is not None and c.n_devices > 1:
            from .parallel import make_mesh
            self.mesh = make_mesh(
                c.n_devices,
                devices=(None if self.device.type == "cuda"
                         else [self.device] * c.n_devices))
        self._spin_sector_n_up: Optional[int] = None
        if self.is_molecular:
            self.n_valid = hamiltonian.n_valid_configs
        elif getattr(hamiltonian, "conserves_magnetization", False):
            # the ground state lies in the fixed-popcount sector of the
            # reference product state: that sector is the search space
            ref = int(self._spin_reference_state_for(hamiltonian)[0])
            self._spin_sector_n_up = bin(ref).count("1")
            self.n_valid = comb(hamiltonian.n_sites, self._spin_sector_n_up)
        else:
            self.n_valid = 1 << hamiltonian.n_sites
        c.adapt_to_system_size(self.n_valid)
        if self.is_molecular:
            self.flow = ParticleConservingFlow(
                hamiltonian.n_orbitals, hamiltonian.n_alpha,
                hamiltonian.n_beta, hidden_dims=tuple(c.nf_hidden_dims))
            self.nqs = DenseNQS(2 * hamiltonian.n_orbitals,
                                hidden_dims=tuple(c.nqs_hidden_dims))
            self.hf_state = hamiltonian.get_hf_state()
        else:
            n = hamiltonian.n_sites
            if (self._spin_sector_n_up is not None
                    and c.use_particle_conserving_flow):
                self.flow = SzConservingFlow(n, self._spin_sector_n_up)
            else:
                self.flow = DiscreteFlowSampler(
                    n, hidden=max(64, c.nf_hidden_dims[0] // 2))
            self.nqs = DenseNQS(n, hidden_dims=tuple(c.nqs_hidden_dims))
            self.hf_state = self._spin_reference_state_for(hamiltonian)
        self.trainer = None
        self.nf_basis: Optional[np.ndarray] = None
        self.timer = StageTimer()
        self.checkpoints = (CheckpointManager(c.checkpoint_dir)
                            if c.checkpoint_dir else None)

    # ------------------------------------------------------------------
    # Stage 1
    # ------------------------------------------------------------------

    def train_flow_nqs(self) -> Dict:
        c = self.config
        if c.verbose:
            print("\n[Stage 1] NF-NQS co-training")
        if not self.is_molecular:
            return self._train_flow_nqs_spin()
        if not c.use_local_energy:
            # the subspace-energy objective: the exact Rayleigh quotient
            # over the accumulated basis instead of sampled local energies
            return self._train_flow_nqs_subspace()
        mem = MemoryBudget.for_device(self.device)
        tcfg = PhysicsGuidedConfig(
            num_epochs=c.max_epochs, min_epochs=c.min_epochs,
            samples_per_batch=c.samples_per_batch,
            num_batches=c.num_batches,
            teacher_weight=c.teacher_weight,
            physics_weight=c.physics_weight,
            entropy_weight=c.entropy_weight,
            flow_lr=c.nf_lr, nqs_lr=c.nqs_lr,
            convergence_threshold=c.convergence_threshold,
            max_accumulated_basis=c.max_accumulated_basis,
            # the periodic accumulated-basis diagonalization is a host
            # diagnostic; throttle it for large caps
            accumulated_energy_interval=(
                50 if c.max_accumulated_basis <= 4096 else 200),
            nqs_chunk_size=mem.nqs_chunk_size(self.h.n_sites,
                                              c.nqs_hidden_dims),
            connection_table_max_entries=mem.connection_table_entries(),
            dense_local_energy_max_dim=mem.dense_hamiltonian_cap(),
            seed=c.seed, verbose=c.verbose)
        self.trainer = PhysicsGuidedFlowTrainer(self.h, self.flow, self.nqs,
                                                tcfg, mesh=self.mesh)
        if c.use_ci_seeding:
            seed_basis = self._ci_seed_basis()
            self.trainer._update_accumulated_basis(seed_basis,
                                                   len(seed_basis))
        t0 = time.perf_counter()
        history = self.trainer.train()
        self.results["stage1"] = {
            "history": history,
            "final_energy": history["energies"][-1],
            "n_epochs": len(history["energies"]),
            "wall_time": time.perf_counter() - t0,
            "stage_times": self.timer.summary(),
        }
        return self.results["stage1"]

    @staticmethod
    def _spin_reference_state_for(h) -> np.ndarray:
        """Lowest-diagonal product state among all-down, all-up and
        Neel: a (1,) uint32 word."""
        n = h.n_sites
        neel = sum(1 << i for i in range(0, n, 2))
        cands = np.array([[0], [(1 << n) - 1], [neel]], np.uint32)
        return cands[int(np.argmin(h.diagonal_np(cands)))]

    def _train_flow_nqs_spin(self) -> Dict:
        c = self.config
        tcfg = PhysicsGuidedConfig(
            num_epochs=c.max_epochs, min_epochs=c.min_epochs,
            samples_per_batch=c.samples_per_batch,
            teacher_weight=c.teacher_weight, physics_weight=c.physics_weight,
            entropy_weight=c.entropy_weight, flow_lr=c.nf_lr,
            nqs_lr=c.nqs_lr, convergence_threshold=c.convergence_threshold,
            max_accumulated_basis=c.max_accumulated_basis,
            seed=c.seed, verbose=c.verbose)
        self.trainer = SpinFlowTrainer(self.h, self.flow, self.nqs, tcfg)
        t0 = time.perf_counter()
        history = self.trainer.train()
        self.results["stage1"] = {
            "history": history,
            "final_energy": history["energies"][-1],
            "n_epochs": len(history["energies"]),
            "wall_time": time.perf_counter() - t0,
            "mode": "spin",
        }
        return self.results["stage1"]

    def _train_flow_nqs_subspace(self) -> Dict:
        c = self.config
        tcfg = TrainingConfig(
            num_epochs=c.max_epochs, min_epochs=c.min_epochs,
            samples_per_batch=c.samples_per_batch,
            nqs_lr=c.nqs_lr, flow_lr=c.nf_lr,
            max_basis_size=c.max_accumulated_basis,
            seed=c.seed, verbose=c.verbose)
        trainer = FlowNQSTrainer(self.h, self.flow, self.nqs, tcfg)
        t0 = time.perf_counter()
        history = trainer.train()
        # stage 2 reads the trainer's accumulated basis and its NQS
        trainer.accumulated_basis = trainer.cache.basis
        self.trainer = trainer
        self.results["stage1"] = {
            "history": history,
            "final_energy": history["energies"][-1],
            "n_epochs": len(history["energies"]),
            "wall_time": time.perf_counter() - t0,
            "mode": "subspace_energy",
        }
        return self.results["stage1"]

    def _ci_seed_basis(self) -> np.ndarray:
        """HF + all singles/doubles as a seed (``use_ci_seeding``)."""
        conn, _ = self.h.connections_np(self.hf_state[None, :])
        return np.concatenate([self.hf_state[None, :], conn[0]], axis=0)

    # ------------------------------------------------------------------
    # Stage 2
    # ------------------------------------------------------------------

    def extract_and_select_basis(self) -> Dict:
        c = self.config
        if c.verbose:
            print("\n[Stage 2] Basis extraction + diversity selection")
        if self.trainer is None or self.trainer.accumulated_basis is None:
            raise RuntimeError("run train_flow_nqs first")
        accumulated = self.trainer.accumulated_basis
        if not self.is_molecular:
            return self._select_basis_spin(accumulated)

        occ = unpack_np(accumulated, self.h.n_orbitals)
        audit = verify_particle_conservation(
            occ, self.h.n_alpha, self.h.n_beta, self.h.n_orbitals)
        if not audit["all_valid"]:
            raise AssertionError(f"particle conservation violated: {audit}")

        if c.use_diversity_selection and len(accumulated) > c.max_diverse_configs:
            with torch.no_grad():
                la = self.trainer.nqs(torch.as_tensor(
                    occ, dtype=torch.float32, device=self.device))
            la = la.cpu().numpy()
            probs = np.exp(2.0 * (la - la.max()))
            probs = probs / probs.sum()
            energies = self.h.diagonal_np(accumulated)
            selector = DiversitySelector(
                self.hf_state,
                DiversityConfig(max_configs=c.max_diverse_configs,
                                rank_2_fraction=c.rank_2_fraction))
            selected, stats = selector.select(accumulated, probs, energies)
        else:
            selected, stats = accumulated, {"n_selected": len(accumulated)}

        # always include the HF reference
        keys = self.h.keys(selected)
        if self.h.keys(self.hf_state[None, :])[0] not in keys:
            selected = np.concatenate([self.hf_state[None, :], selected])

        self.nf_basis = selected
        e_nf = float(self.h.exact_ground_state(selected, k=1)[0][0])
        self.results["stage2"] = {
            "nf_basis_size": int(len(selected)),
            "nf_energy": e_nf,
            "selection_stats": stats,
            "audit": audit,
        }
        if c.verbose:
            err = (f"  err={1000 * (e_nf - self.exact_energy):+.3f} mHa"
                   if self.exact_energy is not None else "")
            print(f"  selected {len(selected)} configs, E={e_nf:.6f}{err}")
        return self.results["stage2"]

    def _select_basis_spin(self, accumulated: np.ndarray) -> Dict:
        """Spin stage 2: the ``max_diverse_configs`` configurations of
        largest NQS |psi|^2 (spins have no excitation ranks), plus the
        reference state."""
        c = self.config
        shifts = np.arange(self.h.n_sites, dtype=np.uint32)
        occ = ((accumulated[:, 0:1] >> shifts) & 1).astype(np.float32)
        with torch.no_grad():
            la = self.trainer.nqs(torch.as_tensor(
                occ, device=self.device)).cpu().numpy()
        if len(accumulated) > c.max_diverse_configs:
            keep = np.sort(np.argsort(-la)[:c.max_diverse_configs])
            selected = accumulated[keep]
        else:
            selected = accumulated
        if self.hf_state[0] not in selected[:, 0]:
            selected = np.concatenate([self.hf_state[None, :], selected])
        self.nf_basis = selected
        e_nf = float(self.h.exact_ground_state(selected, k=1)[0][0])
        self.results["stage2"] = {
            "nf_basis_size": int(len(selected)), "nf_energy": e_nf,
            "selection_stats": {"mode": "top_psi2"}, "audit": {"spin": True},
        }
        if c.verbose:
            err = (f"  err={1000 * (e_nf - self.exact_energy):+.3f} mHa"
                   if self.exact_energy is not None else "")
            print(f"  selected {len(selected)} configs, E={e_nf:.6f}{err}")
        return self.results["stage2"]

    # ------------------------------------------------------------------
    # Stage 3
    # ------------------------------------------------------------------

    def run_residual_expansion(self) -> Dict:
        c = self.config
        if c.verbose:
            print("\n[Stage 3] PT2 residual expansion")
        if self.nf_basis is None:
            raise RuntimeError("run extract_and_select_basis first")
        if not c.use_residual_expansion:
            e = float(self.h.exact_ground_state(self.nf_basis, k=1)[0][0])
            self.results["stage3"] = {"energy": e, "basis": self.nf_basis,
                                      "skipped": True}
            return self.results["stage3"]

        rcfg = ResidualExpansionConfig(
            configs_per_iteration=c.residual_configs_per_iter,
            residual_threshold=c.residual_threshold,
            max_iterations=c.residual_iterations,
            max_basis_size=max(c.max_accumulated_basis,
                               len(self.nf_basis)
                               + c.residual_iterations
                               * c.residual_configs_per_iter),
            use_davidson=c.use_davidson)
        expander = SelectedCIExpander(self.h, rcfg, mesh=self.mesh)

        basis = self.nf_basis
        best_energy = np.inf
        best_basis = basis
        stall = 0
        energies: List[float] = []
        for it in range(c.residual_iterations):
            n_add = None
            if c.residual_growth_factor > 0:
                n_add = max(c.residual_configs_per_iter,
                            int(c.residual_growth_factor * len(basis)))
            out = expander.expand_basis(basis, n_add=n_add)
            e = out["energy"]
            energies.append(e)
            improvement = best_energy - e
            if e < best_energy:
                best_energy, best_basis = e, out["basis"]
            basis = out["basis"]
            if c.verbose:
                print(f"  iter {it}: E={e:.6f} basis={len(basis)} "
                      f"added={out['n_added']}")
            if not out["accepted"]:
                break
            # early stopping: <0.05 mHa improvement twice -> stop
            if improvement < 0.05 * MHA:
                stall += 1
                if stall >= 2:
                    break
            else:
                stall = 0

        if c.verbose:
            t = expander.timings
            print(f"  [sci timings] diag {t['diag']:.1f} s, "
                  f"pt2-score {t['score']:.1f} s")
        self.results["stage3"] = {
            "energy": float(best_energy),
            "energies": energies,
            "basis": best_basis,
            "basis_size": int(len(best_basis)),
            "n_iterations": len(energies),
            "timings": dict(expander.timings),
        }
        if c.verbose and self.exact_energy is not None:
            print(f"  residual E={best_energy:.6f} "
                  f"err={1000 * (best_energy - self.exact_energy):+.3f} mHa")
        return self.results["stage3"]

    # ------------------------------------------------------------------
    # Stage 4
    # ------------------------------------------------------------------

    def _supported_evolution_dim(self) -> int:
        return supported_evolution_dim(self.h, self.mesh)

    def _statevector_sites_cap(self) -> int:
        """Most spins whose 2^n statevector the Trotter propagator holds
        on this device; a mesh of d physical cards (a power of two) that
        can shard the larger state adds log2(d) sites, as in the JAX
        package (a logical mesh adds none)."""
        cap = MemoryBudget.for_device(self.device).statevector_sites_cap()
        if self.mesh is not None:
            from .parallel.sharded_trotter import mesh_supports_statevector
            d = self.mesh.n_physical
            extra = d.bit_length() - 1 if d & (d - 1) == 0 else 0
            if extra and mesh_supports_statevector(self.mesh, cap + extra):
                cap += extra
        return cap

    def run_skqd(self) -> Dict:
        c = self.config
        if c.verbose:
            print("\n[Stage 4] SKQD refinement")
        stage3 = self.results.get("stage3")
        residual_energy = stage3["energy"] if stage3 else None
        residual_basis = stage3["basis"] if stage3 else self.nf_basis

        skip_reason = None
        restricted_states = None
        if c.skip_skqd:
            skip_reason = "config.skip_skqd"
        elif c.max_krylov_dim <= 0:
            skip_reason = "max_krylov_dim <= 0"
        elif self.is_molecular and self.n_valid > max(
                200_000, self._supported_evolution_dim()):
            # Full-space evolution is out of reach: evolve within a
            # restricted subspace, the stage-3 basis plus the strongest
            # PT2-ranked externals, sized to what the routed propagator
            # supports (dense rows or the ELL table).  Sampling the evolved
            # state still finds determinants the variational stages missed.
            cap = self._supported_evolution_dim()
            min_room = max(64, len(residual_basis) // 10)
            if cap < len(residual_basis) + min_room:
                skip_reason = (f"propagator cap {cap:,} leaves no room "
                               f"beyond the {len(residual_basis):,}-config "
                               f"stage-3 basis")
            else:
                restricted_states = build_restricted_subspace(
                    self.h, residual_basis, cap,
                    initial_state=self.hf_state, mesh=self.mesh)
                if c.verbose:
                    print(f"  restricted evolution subspace: "
                          f"{len(restricted_states):,} states "
                          f"(full space {self.n_valid:,})")
        elif not self.is_molecular and self.h.n_sites > \
                self._statevector_sites_cap():
            # spin models evolve in their sector or as a full 2^n
            # statevector (Trotter); the ceiling is memory-derived
            skip_reason = (f"statevector too large for Trotter SKQD "
                           f"(2^{self.h.n_sites} amplitudes)")
        elif (self.exact_energy is not None and residual_energy is not None
              and residual_energy - self.exact_energy < 1.0 * MHA):
            skip_reason = "residual already < 1 mHa"
        elif (self.exact_energy is not None and residual_energy is not None
              and len(residual_basis) < 300
              and residual_energy - self.exact_energy < 2.0 * MHA):
            skip_reason = "small basis already < 2 mHa"
        elif self.exact_energy is None and len(residual_basis) < 300:
            # no exact reference: a < 300-config basis is diagonalized
            # directly, SKQD adds nothing
            skip_reason = "small basis, no exact reference"

        if skip_reason is not None:
            e = (residual_energy if residual_energy is not None else
                 float(self.h.exact_ground_state(self.nf_basis, k=1)[0][0]))
            # the results always carry skqd_energy (the fallback here)
            self.results["stage4"] = {
                "skipped": True, "reason": skip_reason,
                "skqd_energy": float(e),
                "final_energy": float(e),
            }
            if c.verbose:
                print(f"  skipped ({skip_reason})")
            return self.results["stage4"]

        skqd = FlowGuidedSKQD(
            self.h, residual_basis,
            SKQDConfig(max_krylov_dim=c.max_krylov_dim,
                       time_step=c.time_step,
                       shots_per_krylov=c.shots_per_krylov,
                       regularization=c.skqd_regularization,
                       seed=c.seed,
                       verbose=c.verbose),
            initial_state=self.hf_state, mesh=self.mesh,
            subspace_states=restricted_states)
        out = skqd.run_with_nf()

        skqd_energy = out["best_stable_energy"]
        # validation: reject energies below exact - 1 mHa as numerical
        # instability
        if (self.exact_energy is not None
                and skqd_energy < self.exact_energy - 1.0 * MHA):
            if c.verbose:
                print(f"  [warn] SKQD energy {skqd_energy:.6f} below "
                      f"exact - 1 mHa; rejecting as unstable")
            skqd_energy = residual_energy if residual_energy is not None \
                else out["nf_only_energy"]
        final = (min(skqd_energy, residual_energy)
                 if residual_energy is not None else skqd_energy)

        self.results["stage4"] = {
            "skipped": False,
            "skqd": out,
            "skqd_energy": float(skqd_energy),
            "final_energy": float(final),
        }
        if restricted_states is not None:
            self.results["stage4"]["restricted_dim"] = len(restricted_states)
        if c.verbose and self.exact_energy is not None:
            print(f"  SKQD E={skqd_energy:.6f} "
                  f"err={1000 * (skqd_energy - self.exact_energy):+.3f} mHa")
        return self.results["stage4"]

    # ------------------------------------------------------------------

    def run(self, resume: bool = False) -> Dict:
        """The four stages.  With ``resume=True`` and a ``checkpoint_dir``,
        stages 2 and 3 are restored from their checkpoints where they
        exist (stage 1 with stage 2: its record says ``resumed``) instead
        of run; stage 4 always runs."""
        t0 = time.perf_counter()
        ck = self.checkpoints
        if resume and ck is not None and ck.has_stage("stage2"):
            st = ck.load_stage("stage2")
            self.nf_basis = st["nf_basis"].numpy().astype(np.uint32)
            e_nf = float(self.h.exact_ground_state(self.nf_basis, k=1)[0][0])
            self.results["stage1"] = {"history": {}, "final_energy": e_nf,
                                      "n_epochs": 0, "wall_time": 0.0,
                                      "resumed": True}
            self.results["stage2"] = {"nf_basis_size": len(self.nf_basis),
                                      "nf_energy": e_nf, "resumed": True,
                                      "selection_stats": {}, "audit": {}}
        else:
            with self.timer.span("stage1_train"):
                self.train_flow_nqs()
            if ck is not None:
                ck.save_trainer("stage1", self.trainer)
            with self.timer.span("stage2_select"):
                self.extract_and_select_basis()
            if ck is not None:
                ck.save_stage("stage2", {"nf_basis": self.nf_basis})
        if resume and ck is not None and ck.has_stage("stage3"):
            st = ck.load_stage("stage3")
            basis = st["basis"].numpy().astype(np.uint32)
            self.results["stage3"] = {
                "energy": float(st["energy"]), "basis": basis,
                "basis_size": int(len(basis)),
                "energies": [], "n_iterations": 0, "resumed": True}
        else:
            with self.timer.span("stage3_residual"):
                self.run_residual_expansion()
            if ck is not None:
                ck.save_stage("stage3", {
                    "basis": self.results["stage3"]["basis"],
                    "energy": self.results["stage3"]["energy"]})
        with self.timer.span("stage4_skqd"):
            self.run_skqd()

        final = self.results["stage4"]["final_energy"]
        out = {
            "nf_nqs_energy": float(self.results["stage1"]["final_energy"]),
            "nf_energy": float(self.results["stage2"]["nf_energy"]),
            "nf_basis_size": self.results["stage2"]["nf_basis_size"],
            "residual_energy": float(self.results["stage3"]["energy"]),
            "residual_basis_size": self.results["stage3"].get("basis_size"),
            "skqd_energy": self.results["stage4"].get("skqd_energy"),
            "combined_energy": float(final),
            "final_energy": float(final),
            "wall_time": time.perf_counter() - t0,
            "stage_times": self.timer.summary(),
        }
        if self.exact_energy is not None:
            out["exact_energy"] = self.exact_energy
            out["error_mha"] = 1000 * (final - self.exact_energy)
            out["chemical_accuracy"] = \
                abs(final - self.exact_energy) < CHEMICAL_ACCURACY
        self.results["summary"] = out
        if self.config.verbose:
            self._print_summary(out)
        return out

    def _print_summary(self, out: Dict):
        print("\n" + "=" * 60)
        print("Pipeline summary")
        print("-" * 60)
        print(f"  NF basis energy     : {out['nf_energy']:.6f} "
              f"({out['nf_basis_size']} configs)")
        print(f"  Residual energy     : {out['residual_energy']:.6f}")
        if out.get("skqd_energy") is not None:
            print(f"  SKQD energy         : {out['skqd_energy']:.6f}")
        print(f"  Final energy        : {out['final_energy']:.6f}")
        if "exact_energy" in out:
            print(f"  Exact (FCI)         : {out['exact_energy']:.6f}")
            print(f"  Error               : {out['error_mha']:+.4f} mHa "
                  f"[{'PASS' if out['chemical_accuracy'] else 'FAIL'}"
                  f" @ 1.6 mHa]")
        print(f"  Wall time           : {out['wall_time']:.1f} s")
        print("=" * 60)


def run_molecular_benchmark(molecule: str,
                            config: Optional[PipelineConfig] = None,
                            compute_exact: bool = True,
                            device="cuda") -> Dict:
    """Molecule name -> factory on ``device`` -> FCI -> pipeline.run."""
    molecule = molecule.lower()
    if molecule not in MOLECULE_FACTORIES:
        raise ValueError(f"unknown molecule {molecule!r}; "
                         f"available: {sorted(MOLECULE_FACTORIES)}")
    h = MOLECULE_FACTORIES[molecule](device)
    exact = h.fci_energy() if compute_exact else None
    pipeline = FlowGuidedKrylovPipeline(h, config, exact_energy=exact)
    out = pipeline.run()
    out["molecule"] = molecule
    return out


# Aliases of the JAX package's public API
EnhancedFlowKrylovPipeline = FlowGuidedKrylovPipeline
EnhancedPipelineConfig = PipelineConfig
