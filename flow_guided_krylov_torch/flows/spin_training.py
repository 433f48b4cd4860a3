"""Stage-1 trainer for spin systems: a spin flow co-trained with an NQS.

Counterpart of ``flow_guided_krylov_tpu/flows/spin_training.py``: the
flow (:class:`~.discrete.DiscreteFlowSampler`, or
:class:`~.particle_conserving.SzConservingFlow` for a model that conserves
S_z) and the NQS train on the molecular trainer's mixed objective (teacher
cross-entropy + physics + entropy for the flow, REINFORCE for the NQS),
with local energies from the Hamiltonian's device closures
(``hamiltonians/spin.py``).  The JAX package's jitted step is an eager
step here, on the Hamiltonian's device:

1. :meth:`SpinFlowTrainer.sample` draws B configurations (no gradient);
2. :meth:`SpinFlowTrainer.update` packs them into one int64 word each,
   sorts them and compacts the unique ones to the front (padded with 0),
   takes local energies, both losses and both AdamW updates, reads the
   metrics and the unique words once, and merges them into the host
   accumulated basis (NumPy, bit for bit the JAX package's).

The optimizers are the molecular trainer's :class:`OptaxAdamW` (optax's
clip + AdamW + cosine).  Noise comes from the trainer's device generator,
or from the caller (the parity tests feed the JAX step's).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .physics_guided_training import OptaxAdamW, PhysicsGuidedConfig

__all__ = ["SpinFlowTrainer"]


class SpinFlowTrainer:
    """Co-trains a spin flow and an NQS on a one-word spin Hamiltonian.

    Both networks start from ``config.seed`` (a CPU generator, so every
    device starts from the same weights); samples and the flow's Monte
    Carlo noise come from the trainer's own device generator."""

    def __init__(self, hamiltonian, flow, nqs,
                 config: Optional[PhysicsGuidedConfig] = None,
                 n_mc_prob: int = 32):
        self.h = hamiltonian
        self.config = c = config or PhysicsGuidedConfig()
        self.n_mc_prob = n_mc_prob
        self.device = hamiltonian.device
        init = torch.Generator().manual_seed(c.seed)
        flow.reset_parameters(init)
        nqs.reset_parameters(init)
        self.flow = flow.to(self.device)
        self.nqs = nqs.to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(c.seed)
        self.flow_opt = OptaxAdamW(self.flow.parameters(), c.flow_lr,
                                   c.num_epochs, c.weight_decay, c.grad_clip)
        self.nqs_opt = OptaxAdamW(self.nqs.parameters(), c.nqs_lr,
                                  c.num_epochs, c.weight_decay, c.grad_clip)
        n = hamiltonian.n_sites
        self._shifts = torch.arange(n, device=self.device)
        self._pow2 = 1 << self._shifts

        self.accumulated_basis: Optional[np.ndarray] = None   # (M, 1) uint32
        self._acc_keys: Optional[np.ndarray] = None
        self.energy_ema: Optional[float] = None
        self.history: Dict[str, list] = {
            "energies": [], "teacher_losses": [], "physics_losses": [],
            "entropy_values": [], "unique_ratios": [], "basis_sizes": [],
            "epoch_times": [], "accumulated_energies": [],
        }

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _unpack(self, packed: torch.Tensor) -> torch.Tensor:
        """(R,) int64 words -> (R, n) float32 site occupations."""
        return ((packed[:, None] >> self._shifts) & 1).to(torch.float32)

    @staticmethod
    def _unique_compact(packed: torch.Tensor):
        """Sort (B,) words and compact the unique ones to the front,
        padded with 0; returns (words (B,), n_unique as a device scalar)."""
        B = packed.shape[0]
        s = torch.sort(packed).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        pos = torch.where(first, torch.cumsum(first, 0) - 1,
                          torch.full_like(s, B))
        buf = torch.zeros(B + 1, dtype=s.dtype, device=s.device)
        buf.scatter_(0, pos, s)          # duplicates land in the spare slot
        return buf[:B], first.sum()

    @torch.no_grad()
    def local_energies(self, packed_u: torch.Tensor, la_x: torch.Tensor
                       ) -> torch.Tensor:
        """E_loc(x) = sum_y H_xy psi(y) / psi(x) of (B,) int64 words,
        given their log-amplitudes ``la_x``."""
        words = packed_u[:, None]
        diag = self.h.diagonal_device(words)
        conn, elems = self.h.connections_device(words)
        la_y = self.nqs(self._unpack(conn[..., 0].reshape(-1)))
        ratios = torch.exp(la_y.reshape(elems.shape) - la_x[:, None])
        return diag + (elems * ratios).sum(-1)

    @torch.no_grad()
    def sample(self, noise=None) -> torch.Tensor:
        """(B, n) hard 0/1 float32 configurations from the flow;
        ``noise`` replaces the generator's draw (the flow's ``sample``
        says what it holds)."""
        configs, _ = self.flow.sample(self.config.samples_per_batch,
                                      generator=self.generator, noise=noise)
        return torch.round(configs)

    def update(self, configs: torch.Tensor,
               eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One training step on sampled (B, n) configurations: local
        energies, both losses and updates, then the host merge of the
        unique configurations into the accumulated basis.  ``eps``
        (n_mc, B, n) replaces the flow's Monte Carlo draw.  Returns the
        step's metrics."""
        c = self.config
        B = configs.shape[0]
        dev = configs.device
        packed_u, n_unique = self._unique_compact(
            (configs.long() * self._pow2).sum(-1))
        valid = torch.arange(B, device=dev) < n_unique
        occ_u = self._unpack(packed_u)
        neg_inf = torch.full((B,), -torch.inf, device=dev)

        with torch.no_grad():
            la_x = self.nqs(occ_u)
            e_loc = torch.where(valid, self.local_energies(packed_u, la_x),
                                torch.zeros_like(la_x))
            p_nqs = torch.softmax(torch.where(valid, 2.0 * la_x, neg_inf), 0)
            energy = (e_loc * p_nqs).sum()

        probs = self.flow.estimate_discrete_prob(
            occ_u, self.n_mc_prob, generator=self.generator, eps=eps)
        lp = torch.where(valid, torch.log(probs + 1e-30), neg_inf)
        log_flow = torch.where(valid, torch.log_softmax(lp, 0),
                               torch.zeros_like(lp))
        p_flow = torch.exp(log_flow) * valid
        teacher = -(p_nqs * log_flow).sum()
        physics = (p_flow * (e_loc - energy)).sum()
        entropy = -(p_flow * log_flow).sum()
        flow_loss = (c.teacher_weight * teacher + c.physics_weight * physics
                     - c.entropy_weight * entropy) / (energy.abs() + 1.0)
        f_grads = torch.autograd.grad(flow_loss, self.flow_opt.params)
        nqs_loss = ((e_loc - energy) * (2.0 * self.nqs(occ_u)) * p_nqs).sum()
        n_grads = torch.autograd.grad(nqs_loss, self.nqs_opt.params)
        self.flow_opt.step(f_grads)
        self.nqs_opt.step(n_grads)

        # the host reads the metrics (with the unique count) and the words
        vec = torch.stack([energy, teacher.detach(), physics.detach(),
                           entropy.detach(), n_unique / B,
                           n_unique.to(torch.float32)]).cpu().numpy()
        self._accumulate(packed_u.cpu().numpy().astype(np.uint32),
                         int(vec[5]))
        return {"energy": float(vec[0]), "teacher_loss": float(vec[1]),
                "physics_loss": float(vec[2]), "entropy": float(vec[3]),
                "unique_ratio": float(vec[4])}

    def step(self) -> Dict[str, float]:
        return self.update(self.sample())

    def _accumulate(self, packed_u: np.ndarray, n_unique: int):
        """Union the step's unique words into the sorted host keys; past
        ``max_accumulated_basis`` keep a random subset drawn from a
        generator seeded with the union's size (the JAX package's rule)."""
        new = packed_u[:n_unique].astype(np.uint64)
        if self._acc_keys is None:
            self._acc_keys = np.unique(new)
        else:
            self._acc_keys = np.union1d(self._acc_keys, new)
        cap = self.config.max_accumulated_basis
        if len(self._acc_keys) > cap:
            rng = np.random.default_rng(len(self._acc_keys))
            self._acc_keys = np.sort(
                rng.permutation(self._acc_keys)[:cap])
        self.accumulated_basis = self._acc_keys.astype(np.uint32)[:, None]

    # ------------------------------------------------------------------
    # Training loop
    # ------------------------------------------------------------------

    def train(self) -> Dict[str, list]:
        c = self.config
        for epoch in range(c.num_epochs):
            t0 = time.perf_counter()
            m = self.step()
            self.energy_ema = (m["energy"] if self.energy_ema is None
                               else c.ema_decay * self.energy_ema
                               + (1 - c.ema_decay) * m["energy"])
            self.history["energies"].append(m["energy"])
            self.history["teacher_losses"].append(m["teacher_loss"])
            self.history["physics_losses"].append(m["physics_loss"])
            self.history["entropy_values"].append(m["entropy"])
            self.history["unique_ratios"].append(m["unique_ratio"])
            self.history["basis_sizes"].append(len(self.accumulated_basis))
            self.history["epoch_times"].append(time.perf_counter() - t0)
            if c.verbose and epoch % 25 == 0:
                print(f"  [spin] epoch {epoch}: E={m['energy']:.6f} "
                      f"unique={m['unique_ratio']:.2f} "
                      f"basis={len(self.accumulated_basis)}")
            if epoch >= c.min_epochs and \
                    m["unique_ratio"] < c.convergence_threshold:
                if c.verbose:
                    print(f"  [spin] converged at epoch {epoch}")
                break
        return self.history
