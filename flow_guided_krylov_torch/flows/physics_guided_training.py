"""Physics-guided flow + NQS co-training (stage 1).

Counterpart of ``flow_guided_krylov_tpu/flows/physics_guided_training.py``:
the same objectives, schedules and convergence rules, with the jitted step
rebuilt as an eager PyTorch step on the Hamiltonian's device.  One epoch:

1. :meth:`PhysicsGuidedFlowTrainer.sample` draws B determinants from the
   flow (no gradient);
2. :meth:`PhysicsGuidedFlowTrainer.update` sorts their int64 keys and
   compacts the unique ones to the front (padded with HF), computes local
   energies on one of three routes (dense ``H psi`` over the enumerated
   space, gathers from the device connection table, or connections made on
   the fly), takes both losses and both AdamW updates, and merges the
   uniques into the device-resident accumulated basis (pruned to a random
   subset at the cap).

Every shape in the step is static (B samples, M accumulated keys), so it
never stops the host: no ``unique``, boolean-mask indexing, ``nonzero`` or
``.item()``.  The host reads one packed metrics vector per step.  The
optimizers follow optax's ``chain(clip_by_global_norm, adamw(cosine))``.

With a ``mesh`` (``parallel.make_mesh``, its first device the
Hamiltonian's) the step is data-parallel in one process, where the JAX
package put sharding constraints on the batch, the connections and H's
rows.  The parameters and both optimizers stay on the first device; every
network evaluation splits its rows over the mesh's entries, each shard
running ``torch.func.functional_call`` on copies of the parameters on its
entry's device (a differentiable ``.to``), and the outputs come back to
the first device, where the losses are taken as without a mesh and one
optimizer step follows.  The dense route's H is row-sharded
(``parallel.shard_hamiltonian_rows``).  Sampling, dedup and the
accumulated basis stay on the first device, so one seed draws the same
configurations with or without a mesh.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.bits import (keys_device, to_device, to_host, unkey_device,
                        unpack_device)
from ..parallel.mesh import canonical
from ..parallel.mesh import to as mesh_to
from ..utils.profiling import count, span
from ..utils.system_scaler import AdaptiveAdjuster

__all__ = ["PhysicsGuidedConfig", "PhysicsGuidedFlowTrainer",
           "OptaxAdamW", "SENTINEL_KEY"]

# the device key of the (0xFFFFFFFF, 0xFFFFFFFF) sentinel: int64 max, so
# it sorts after every determinant
SENTINEL_KEY = (1 << 63) - 1


@dataclass
class PhysicsGuidedConfig:
    """Stage-1 hyperparameters (the JAX package's names and defaults)."""
    num_epochs: int = 400
    min_epochs: int = 100
    samples_per_batch: int = 2000
    num_batches: int = 1               # gradient steps per epoch
    teacher_weight: float = 0.5
    physics_weight: float = 0.4
    entropy_weight: float = 0.1
    flow_lr: float = 5e-4
    nqs_lr: float = 1e-3
    grad_clip: float = 1.0
    weight_decay: float = 0.01
    initial_temperature: float = 1.0
    final_temperature: float = 0.1
    temperature_decay_epochs: int = 200
    convergence_threshold: float = 0.20
    ema_decay: float = 0.9
    max_accumulated_basis: int = 4096
    use_accumulated_energy: bool = True
    accumulated_energy_interval: int = 50
    nqs_chunk_size: int = 16384
    early_exit_on_complete_basis: bool = True  # stop when the whole space
                                               # is in the accumulated basis
    use_connection_table: bool = True   # precompute all connections on device
    connection_table_max_entries: int = 50_000_000
    # for enumerable spaces <= this many rows, keep the dense subspace H on
    # the device and compute all local energies as one matrix-vector
    # product per step (e_loc = (H psi)[i] / psi[i])
    dense_local_energy_max_dim: int = 20_000
    seed: int = 0
    verbose: bool = True


class OptaxAdamW:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(
    cosine_decay_schedule(lr, decay_steps), weight_decay=wd))`` over a list
    of parameters:

    * the clip scales every gradient by max_norm / ||g|| when the global
      norm ||g|| reaches max_norm (``torch.nn.utils.clip_grad_norm_`` adds
      1e-6 to the norm and is not the same function);
    * Adam moments with bias correction, u = m_hat / (sqrt(v_hat) + eps);
    * decoupled weight decay on every parameter, u += wd * p;
    * p -= lr(t) * u with lr(t) = lr * (1 + cos(pi * min(t, T) / T)) / 2
      at the update count t before this update.

    ``decay_steps=None`` keeps lr constant; with ``weight_decay=0`` that is
    ``chain(clip_by_global_norm(max_norm), adam(lr))``, and with
    ``max_norm=inf`` too, plain ``adam(lr)``.

    Device-side throughout: the clip's condition is a tensor, never read
    on the host.
    """

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 decay_steps: Optional[int], weight_decay: float = 0.01,
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.decay_steps = lr, decay_steps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def state_dict(self) -> Dict:
        """The Adam moments (one tensor a parameter, in order) and the
        update count."""
        return {"mu": [m.detach().clone() for m in self.mu],
                "nu": [v.detach().clone() for v in self.nu],
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            if len(state[key]) != len(dst):
                raise ValueError(f"{key} holds {len(state[key])} tensors, "
                                 f"the optimizer {len(dst)} parameters")
            for d, s_ in zip(dst, state[key]):
                d.copy_(torch.as_tensor(s_))
        self.count = int(state["count"])

    def learning_rate(self, count: int) -> float:
        if self.decay_steps is None:
            return self.lr
        t = min(count, self.decay_steps)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / self.decay_steps))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        grads = torch._foreach_mul(grads, scale)
        lr = self.learning_rate(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        m_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)


class PhysicsGuidedFlowTrainer:
    """Co-trains a particle-conserving flow and an NQS on one molecular
    Hamiltonian, on the Hamiltonian's device.

    The trainer initializes both networks from ``config.seed`` (a CPU
    generator, so every device starts from the same weights) and draws
    samples and pruning priorities from its own device generator.
    """

    def __init__(self, hamiltonian, flow, nqs,
                 config: Optional[PhysicsGuidedConfig] = None,
                 mesh=None):
        self.h = hamiltonian
        self.config = c = config or PhysicsGuidedConfig()
        self.device = hamiltonian.device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if (self.mesh is not None
                and canonical(mesh.first) != canonical(self.device)):
            raise ValueError(f"the mesh's first device {mesh.first} must be "
                             f"the Hamiltonian's {self.device}")
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

        self.connection_table = None
        self._h_dense: Optional[torch.Tensor] = None
        if c.use_connection_table:
            from ..utils.connection_table import build_connection_table
            with span("stage1.table_build", sync=True):
                self.connection_table = build_connection_table(
                    hamiltonian, max_entries=c.connection_table_max_entries)
            if self.connection_table is not None:
                t = self.connection_table
                count("ctable.rows", t.n_configs)
                count("ctable.entries", t.n_configs * t.n_connections)
            if (self.connection_table is not None
                    and self.connection_table.n_configs
                    <= c.dense_local_energy_max_dim):
                self._h_dense = dense_hamiltonian(self.connection_table)
                if self.mesh is not None:
                    from ..parallel.sharded_matvec import \
                        shard_hamiltonian_rows
                    self._h_dense = shard_hamiltonian_rows(self.mesh,
                                                           self._h_dense)
        self.route = ("dense" if self._h_dense is not None else
                      "table" if self.connection_table is not None else
                      "fly")

        hf = to_device(hamiltonian.get_hf_state()[None, :], self.device)
        self._hf_key = keys_device(hf)[0]
        self._pow2 = 1 << torch.arange(hamiltonian.n_orbitals,
                                       device=self.device)
        # device-resident accumulated basis: sorted int64 keys padded with
        # the sentinel (the host fetches it only at stage boundaries)
        self._acc_keys = torch.full((c.max_accumulated_basis,), SENTINEL_KEY,
                                    dtype=torch.int64, device=self.device)
        self._acc_count = 0
        self.energy_ema: Optional[float] = None
        self.history: Dict[str, list] = {
            "energies": [], "accumulated_energies": [], "teacher_losses": [],
            "physics_losses": [], "entropy_values": [], "unique_ratios": [],
            "basis_sizes": [], "epoch_times": [],
        }
        # wall seconds of each accumulated-basis eigensolve (a host
        # diagnostic between steps, outside ``epoch_times``)
        self.accumulated_energy_times: List[float] = []

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _nqs_chunked(self, occ: torch.Tensor) -> torch.Tensor:
        """Gradient-free NQS log-amplitudes of (R, 2n) rows, in chunks of
        ``nqs_chunk_size`` rows (each shard's rows in its own chunks with a
        mesh)."""
        chunk = max(1, self.config.nqs_chunk_size)

        def chunked(fn, rows):
            return torch.cat([fn(rows[i:i + chunk])
                              for i in range(0, max(rows.shape[0], 1),
                                             chunk)])

        if self.mesh is not None:
            return self._sharded(self.nqs, occ, wrap=chunked)
        return chunked(self.nqs, occ)

    def _sharded(self, module: torch.nn.Module, rows: torch.Tensor,
                 method: Optional[str] = None, wrap=None) -> torch.Tensor:
        """``module(rows)`` (or ``module.<method>(rows)``) with the rows
        split over the mesh: each shard runs ``torch.func.functional_call``
        on copies of the parameters and buffers on its entry's device, and
        the results are concatenated on the first device.  The copies are
        differentiable, so gradients flow back to the first device's
        parameters.  ``wrap(fn, rows)`` applies fn over a shard's rows."""
        mesh = self.mesh
        call = _Call(module, method)
        state = {"m." + k: v for k, v in
                 list(module.named_parameters())
                 + list(module.named_buffers())}
        per = -(-rows.shape[0] // mesh.size)
        outs = []
        for d, dev in enumerate(mesh.devices):
            part = rows[d * per:(d + 1) * per]
            if not len(part):
                continue
            local = {k: mesh_to(v, dev) for k, v in state.items()}

            def fn(x, local=local):
                return torch.func.functional_call(call, local, (x,))

            part = mesh_to(part, dev)
            out = wrap(fn, part) if wrap is not None else fn(part)
            outs.append(mesh_to(out, mesh.first))
        return torch.cat(outs)

    @torch.no_grad()
    def local_energies(self, packed_u: torch.Tensor, la_x: torch.Tensor
                       ) -> torch.Tensor:
        """E_loc(x) = sum_y H_xy psi(y) / psi(x) of (B, 2) int64 words,
        given their log-amplitudes ``la_x``, on this trainer's route.
        Under the profiler it is the span ``stage1.local_energy`` and adds
        the rows its NQS evaluation takes (B x C, or N on ``dense``) to
        the counter ``stage1.nqs_rows``, counted from shapes."""
        with span("stage1.local_energy"):
            n_sites = 2 * self.h.n_orbitals
            if self.route == "dense":
                t = self.connection_table
                idx = t.lookup(packed_u)
                count("stage1.nqs_rows", t.occ.shape[0])
                la_all = self._nqs_chunked(t.occ)
                psi = torch.exp(la_all - la_all.max())
                if self.mesh is not None:
                    from ..parallel.sharded_matvec import sharded_matvec_fn
                    hpsi = sharded_matvec_fn(self.mesh)(self._h_dense, psi)
                else:
                    hpsi = self._h_dense @ psi
                return hpsi[idx] / psi[idx].clamp_min(1e-30)
            if self.route == "table":
                diag, elems, occ_y = \
                    self.connection_table.local_energy_inputs(packed_u)
            else:
                diag = self.h.diagonal_device(packed_u)
                conn, elems = self.h.connections_device(packed_u)
                occ_y = unpack_device(conn, self.h.n_orbitals)
            count("stage1.nqs_rows", elems.numel())
            la_y = self._nqs_chunked(occ_y.reshape(-1, n_sites))
            ratios = torch.exp(la_y.reshape(elems.shape) - la_x[:, None])
            return diag + (elems * ratios).sum(-1)

    def _unique_compact(self, keys: torch.Tensor):
        """Sort (B,) keys and compact the unique ones to the front, padded
        with HF's key; returns (keys (B,), n_unique as a device scalar)."""
        B = keys.shape[0]
        s = torch.sort(keys).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[1:] = s[1:] != s[:-1]
        pos = torch.where(first, torch.cumsum(first, 0) - 1,
                          torch.full_like(s, B))
        buf = self._hf_key.expand(B + 1).clone()
        buf.scatter_(0, pos, s)          # duplicates land in the spare slot
        return buf[:B], first.sum()

    def _merge_accumulate(self, keys_u: torch.Tensor, n_unique: torch.Tensor,
                          priorities: Optional[torch.Tensor] = None):
        """Union the step's uniques into the sorted key buffer of capacity
        M; at the cap keep a uniform random subset (the M valid keys of
        lowest random priority).  Returns (buffer, min(count, M))."""
        M = self._acc_keys.shape[0]
        B = keys_u.shape[0]
        sent = torch.full_like(keys_u, SENTINEL_KEY)
        new = torch.where(torch.arange(B, device=keys_u.device) < n_unique,
                          keys_u, sent)
        a = torch.sort(torch.cat([self._acc_keys, new])).values
        first = torch.ones_like(a, dtype=torch.bool)
        first[1:] = a[1:] != a[:-1]
        valid = first & (a != SENTINEL_KEY)
        count = valid.sum()
        if priorities is None:
            priorities = torch.rand(a.shape, generator=self.generator,
                                    device=a.device)
        pri = torch.where(valid, priorities,
                          torch.full_like(priorities, torch.inf))
        order = torch.argsort(pri, stable=True)[:M]
        keep = a[order]
        keep = torch.where(valid[order], keep,
                           torch.full_like(keep, SENTINEL_KEY))
        return torch.sort(keep).values, torch.clamp(count, max=M)

    def unique_batch(self, configs: torch.Tensor):
        """(B, 2n) 0/1 configurations -> their sorted unique keys (B,)
        padded with HF's, the unique count as a device scalar, and the
        keys' (B, 2) int64 words."""
        n = self.h.n_orbitals
        words = torch.stack([(configs[:, :n].long() * self._pow2).sum(-1),
                             (configs[:, n:].long() * self._pow2).sum(-1)],
                            -1)
        keys_u, n_unique = self._unique_compact(keys_device(words))
        return keys_u, n_unique, unkey_device(keys_u)

    @torch.no_grad()
    def sample(self, temperature: float,
               uniforms: Optional[tuple] = None) -> torch.Tensor:
        """(B, 2n) hard 0/1 float32 configurations from the flow;
        ``uniforms`` = (alpha, beta) (B, n) replaces the generator's."""
        configs, _ = self.flow.sample(self.config.samples_per_batch,
                                      temperature, generator=self.generator,
                                      uniforms=uniforms)
        return torch.round(configs)

    def update(self, configs: torch.Tensor,
               priorities: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One training step on sampled (B, 2n) configurations: local
        energies, both losses and updates, and the accumulated-basis
        merge (``priorities`` (M + B,) replaces the pruning draw).
        Returns the device metrics vector [energy, teacher, physics,
        entropy, unique ratio, accumulated count]; counts
        ``stage1.steps`` under the profiler."""
        c = self.config
        count("stage1.steps")
        B = configs.shape[0]
        keys_u, n_unique, packed_u = self.unique_batch(configs)
        valid = torch.arange(B, device=configs.device) < n_unique
        occ_u = unpack_device(packed_u, self.h.n_orbitals)
        neg_inf = torch.full((B,), -torch.inf, device=configs.device)

        nqs, log_prob = self.nqs, self.flow.log_prob
        if self.mesh is not None:
            def nqs(x):
                return self._sharded(self.nqs, x)

            def log_prob(x):
                return self._sharded(self.flow, x, "log_prob")

        with torch.no_grad():
            la_x = nqs(occ_u)
            e_loc = torch.where(valid, self.local_energies(packed_u, la_x),
                                torch.zeros_like(la_x))
            p_nqs = torch.softmax(torch.where(valid, 2.0 * la_x, neg_inf), 0)
            energy = (e_loc * p_nqs).sum()

        lp = torch.where(valid, log_prob(occ_u), neg_inf)
        log_flow = torch.where(valid, torch.log_softmax(lp, 0),
                               torch.zeros_like(lp))
        p_flow = torch.exp(log_flow) * valid
        teacher = -(p_nqs * log_flow).sum()
        physics = (p_flow * (e_loc - energy)).sum()
        entropy = -(p_flow * log_flow).sum()
        flow_loss = (c.teacher_weight * teacher + c.physics_weight * physics
                     - c.entropy_weight * entropy) / (energy.abs() + 1.0)
        f_grads = torch.autograd.grad(flow_loss, self.flow_opt.params)
        nqs_loss = ((e_loc - energy) * (2.0 * nqs(occ_u)) * p_nqs).sum()
        n_grads = torch.autograd.grad(nqs_loss, self.nqs_opt.params)
        self.flow_opt.step(f_grads)
        self.nqs_opt.step(n_grads)

        with torch.no_grad():
            self._acc_keys, acc_count = self._merge_accumulate(
                keys_u, n_unique, priorities)
            return torch.stack([energy, teacher.detach(), physics.detach(),
                                entropy.detach(), n_unique / B,
                                acc_count.float()])

    def step(self, temperature: float) -> torch.Tensor:
        return self.update(self.sample(temperature))

    # ------------------------------------------------------------------
    # Accumulated basis (host views)
    # ------------------------------------------------------------------

    @property
    def accumulated_basis(self) -> Optional[np.ndarray]:
        """Host (K, 2) uint32 view of the device-resident accumulated
        basis, in key order."""
        if self._acc_count == 0:
            return None
        keys = self._acc_keys[self._acc_keys != SENTINEL_KEY]
        return to_host(unkey_device(keys))

    @accumulated_basis.setter
    def accumulated_basis(self, basis):
        M = self.config.max_accumulated_basis
        buf = torch.full((M,), SENTINEL_KEY, dtype=torch.int64,
                         device=self.device)
        if basis is not None and len(basis):
            basis = np.asarray(basis, np.uint32)[:M]
            keys = torch.sort(keys_device(to_device(basis, self.device)))
            buf[:len(basis)] = keys.values
            self._acc_count = len(basis)
        else:
            self._acc_count = 0
        self._acc_keys = buf

    def _update_accumulated_basis(self, packed: np.ndarray, n: int):
        """Host-side seeding/merge into the device buffer (CI seeding)."""
        extra = np.asarray(packed[:n], np.uint32)
        current = self.accumulated_basis
        merged = (extra if current is None
                  else np.concatenate([current, extra]))
        _, idx = np.unique(self.h.keys(merged), return_index=True)
        self.accumulated_basis = merged[np.sort(idx)]

    def _accumulated_energy(self) -> float:
        """Ground-state energy in the accumulated basis (host f64)."""
        with span("stage1.accumulated_energy"):
            basis = self.accumulated_basis
            if basis is None or not len(basis):
                return float("inf")
            vals, _ = self.h.exact_ground_state(basis)
            return float(vals[0])

    # ------------------------------------------------------------------
    # Training loop
    # ------------------------------------------------------------------

    def temperature_at(self, epoch: int) -> float:
        c = self.config
        progress = min(1.0, epoch / max(1, c.temperature_decay_epochs))
        temp = (c.initial_temperature
                + progress * (c.final_temperature - c.initial_temperature))
        if epoch < getattr(self, "_reheat_until", 0):
            # AdaptiveAdjuster flagged an early flow collapse: reheat to
            # half the initial temperature so sampling re-diversifies
            temp = max(temp, 0.5 * c.initial_temperature)
        return temp

    def train(self) -> Dict[str, list]:
        c = self.config
        # the adjuster's tips drive the two knobs that are live mid-
        # training: the sampling temperature (reheat on early collapse)
        # and the convergence exit (deferred while the energy falls)
        adjuster = AdaptiveAdjuster()
        self.history.setdefault("adjuster_tips", [])
        self._reheat_until = 0
        conv_deferred = 0
        for epoch in range(c.num_epochs):
            t0 = time.perf_counter()
            # float32, as the JAX step receives it
            temp = float(np.float32(self.temperature_at(epoch)))
            batch_metrics = []
            for _ in range(max(1, c.num_batches)):
                vec = self.step(temp).cpu().numpy()   # one host read a step
                batch_metrics.append({
                    "energy": float(vec[0]), "teacher_loss": float(vec[1]),
                    "physics_loss": float(vec[2]), "entropy": float(vec[3]),
                    "unique_ratio": float(vec[4])})
                self._acc_count = int(vec[5])

            m = {k_: sum(bm[k_] for bm in batch_metrics)
                 / len(batch_metrics) for k_ in batch_metrics[0]}
            if self.energy_ema is None:
                self.energy_ema = m["energy"]
            else:
                self.energy_ema = (c.ema_decay * self.energy_ema
                                   + (1 - c.ema_decay) * m["energy"])
            self.history["energies"].append(m["energy"])
            self.history["teacher_losses"].append(m["teacher_loss"])
            self.history["physics_losses"].append(m["physics_loss"])
            self.history["entropy_values"].append(m["entropy"])
            self.history["unique_ratios"].append(m["unique_ratio"])
            self.history["basis_sizes"].append(self._acc_count)
            self.history["epoch_times"].append(time.perf_counter() - t0)

            if (c.use_accumulated_energy
                    and epoch % c.accumulated_energy_interval == 0):
                t1 = time.perf_counter()
                self.history["accumulated_energies"].append(
                    self._accumulated_energy())
                self.accumulated_energy_times.append(time.perf_counter() - t1)

            if c.verbose and (epoch % 25 == 0 or epoch == c.num_epochs - 1):
                print(f"  epoch {epoch:4d}  E={m['energy']:.6f} "
                      f"EMA={self.energy_ema:.6f} "
                      f"unique={m['unique_ratio']:.2f} "
                      f"basis={self.history['basis_sizes'][-1]}")

            tips = adjuster.suggest(self.history)
            if tips:
                self.history["adjuster_tips"].append((epoch, dict(tips)))
                if ("convergence_threshold" in tips
                        and self._reheat_until <= epoch):
                    self._reheat_until = epoch + 25
                    if c.verbose:
                        print("  [adjust] flow collapsed early; reheating "
                              "temperature for 25 epochs")

            if epoch >= c.min_epochs and \
                    m["unique_ratio"] < c.convergence_threshold:
                if "max_epochs" in tips and conv_deferred < c.min_epochs // 2:
                    # energy still improving: defer the exit (bounded)
                    conv_deferred += 1
                else:
                    if c.verbose:
                        print(f"  converged at epoch {epoch}: "
                              f"unique_ratio={m['unique_ratio']:.3f}")
                    break
            # complete-space early exit: once every valid determinant is in
            # the accumulated basis (and fits the cap), further epochs only
            # polish the NQS, whose energy the pipeline does not use
            if (c.early_exit_on_complete_basis and epoch >= c.min_epochs
                    and self._acc_count >= self.h.n_valid_configs):
                if c.verbose:
                    print(f"  basis complete at epoch {epoch}: "
                          f"{self._acc_count:,} configs")
                break
        return self.history


class _Call(torch.nn.Module):
    """``module.<method>`` (``forward`` when None) as a module's forward,
    so that ``torch.func.functional_call`` can run any method."""

    def __init__(self, module: torch.nn.Module, method: Optional[str]):
        super().__init__()
        self.m = module
        self.method = method

    def forward(self, x):
        return (self.m(x) if self.method is None
                else getattr(self.m, self.method)(x))


def dense_hamiltonian(table) -> torch.Tensor:
    """The (N, N) float32 subspace H on the table's device, densified from
    the resident table.  A row's targets are distinct determinants other
    than the row's own, so every (row, target) pair is written once and
    the plain scatter is deterministic."""
    n = table.n_configs
    H = torch.zeros((n, n), dtype=torch.float32, device=table.diag.device)
    rows = torch.arange(n, device=H.device)[:, None].expand_as(
        table.target_idx)
    H[rows, table.target_idx.long()] = table.elems
    H.diagonal().copy_(table.diag)
    return H
