"""The subspace-energy stage-1 trainer, and retraining on a fixed basis.

Counterpart of ``flow_guided_krylov_tpu/flows/training.py`` (the
pipeline's ``use_local_energy=False`` mode):

* :class:`IncrementalHamiltonianCache` — the dense projected H over the
  accumulated basis, held on the Hamiltonian's device in float32 and
  grown in place: an ``extend`` computes only the new determinants'
  columns (their connections on the device, found in the basis by a
  sorted-key search), a ``restrict`` gathers the kept rows and columns.
  The host float64 H that the JAX cache rebuilds every epoch is computed
  only when a caller reads ``cache.H``.
* :class:`_SortedKeyDedup` — host membership over uint64 keys (the JAX
  code).
* :class:`FlowNQSTrainer` — trains the NQS on the subspace energy
  E = c^T H c / c^T c with c_i = |psi(x_i)| over the accumulated basis
  (a deterministic Rayleigh quotient), plus the flow's teacher
  cross-entropy toward |psi|^2; prunes the basis to its top-|psi|^2
  fraction at the cap.
* :class:`InferenceNQSTrainer` — retrains a fresh NQS on a fixed basis,
  halving the learning rate on each of its first two plateaus and
  stopping on the third.

The JAX step pads the basis to a power-of-two capacity with a validity
mask, and the mask makes every padded row contribute exactly zero
(log-amplitude -30 times mask 0, teacher probability 0, flow log-prob 0),
so the port computes on the n valid rows and gets the same numbers.
Both optimizers are optax's ``chain(clip_by_global_norm, adam)``, a
constant rate and no weight decay (``OptaxAdamW`` with
``decay_steps=None``, ``weight_decay=0``); ``InferenceNQSTrainer``'s is
plain ``adam``.  As in the JAX package, ``FlowNQSTrainer.load_checkpoint``
restores params, basis, generator and history but not the optimizer
states (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..hamiltonians.base import _KeyIndex
from ..ops.bits import pack_np, to_device, unpack_device
from ..utils.memory import MemoryBudget
from .physics_guided_training import OptaxAdamW

__all__ = ["TrainingConfig", "IncrementalHamiltonianCache",
           "FlowNQSTrainer", "InferenceNQSTrainer"]


@dataclass
class TrainingConfig:
    """The JAX package's knobs and defaults."""
    num_epochs: int = 300
    min_epochs: int = 50
    samples_per_batch: int = 1000
    nqs_lr: float = 1e-3
    flow_lr: float = 5e-4
    grad_clip: float = 1.0
    max_basis_size: int = 2048
    prune_fraction: float = 0.9       # keep top-|psi|^2 fraction on prune
    convergence_threshold: float = 1e-6
    patience: int = 30
    save_interval: int = 50           # epochs between auto-checkpoints
    checkpoint_dir: Optional[str] = None
    temperature: float = 1.0
    seed: int = 0
    verbose: bool = False


class IncrementalHamiltonianCache:
    """Dense projected H over a growing basis, float32 on the
    Hamiltonian's device.

    ``basis`` is the host (M, W) uint32 view, ``words`` the device (M, W)
    int64 rows, ``H_device`` the (M, M) device block (a view into a
    buffer of ``capacity`` rows, grown in place), ``H`` the host float64
    matrix (computed on first read after a change).  A connection's row
    is found through :class:`_KeyIndex`: one int64 key a row up to 32
    orbitals, an (alpha, beta) int64 pair past them (four words a row)."""

    def __init__(self, hamiltonian, capacity: Optional[int] = None):
        self.h = hamiltonian
        self.device = hamiltonian.device
        self.capacity = capacity
        # new determinants whose connections are live at once
        self.chunk_rows = MemoryBudget.for_device(
            self.device).build_chunk_rows(hamiltonian.n_connections)
        self.basis: Optional[np.ndarray] = None     # (M, W) uint32
        self._H: Optional[torch.Tensor] = None      # (cap, cap) float32
        self._words: Optional[torch.Tensor] = None  # (cap, W) int64
        self._H_host: Optional[np.ndarray] = None
        self.peak_rows = 0

    def __len__(self) -> int:
        return 0 if self.basis is None else len(self.basis)

    @property
    def words(self) -> torch.Tensor:
        return self._words[:len(self)]

    @property
    def H_device(self) -> torch.Tensor:
        n = len(self)
        return self._H[:n, :n]

    @property
    def device_bytes(self) -> int:
        """Bytes of the device buffers (H and words) at their capacity."""
        if self._H is None:
            return 0
        return (self._H.numel() * self._H.element_size()
                + self._words.numel() * self._words.element_size())

    @property
    def H(self) -> Optional[np.ndarray]:
        """Host float64 H, symmetrized (the JAX cache's ``H``)."""
        if self.basis is None:
            return None
        if self._H_host is None:
            M = self.h.matrix_elements(self.basis, self.basis)
            self._H_host = 0.5 * (M + M.T)
        return self._H_host

    def _reserve(self, n: int) -> None:
        cap = 0 if self._H is None else self._H.shape[0]
        if n <= cap:
            return
        new_cap = (self.capacity if (self.capacity or 0) >= n
                   else max(n, 2 * cap))
        H = torch.zeros((new_cap, new_cap), dtype=torch.float32,
                        device=self.device)
        words = torch.zeros((new_cap, self.h.pack_words), dtype=torch.int64,
                            device=self.device)
        if cap:
            m = len(self)
            H[:m, :m] = self._H[:m, :m]
            words[:m] = self._words[:m]
        self._H, self._words = H, words

    @torch.no_grad()
    def _fill_new(self, m: int, n: int) -> None:
        """Rows and columns m..n of H: column j is <basis|H|new_j> from
        new_j's connections (each a distinct determinant, so every write
        lands once), ``chunk_rows`` new determinants at a time; the
        new-new block is symmetrized, as the JAX cache symmetrizes its
        diagonal block."""
        h, H = self.h, self._H
        index = _KeyIndex(h.keys_device(self._words[:n]))
        for a in range(m, n, self.chunk_rows):
            b = min(n, a + self.chunk_rows)
            new = self._words[a:b]
            conn, elems = h.connections_device(new)
            row, hit = index.find(h.keys_device(conn))
            del conn
            rows = torch.where(hit, row, n)           # misses: spare row
            idx = torch.arange(b - a, device=self.device)
            block = torch.zeros((n + 1, b - a), dtype=torch.float32,
                                device=self.device)
            # rows: targets, columns: new_j
            block[rows, idx[:, None].expand_as(rows)] = elems.float()
            block[a + idx, idx] += h.diagonal_device(new)
            H[:n, a:b] = block[:n]
        H[m:n, :m] = H[:m, m:n].T
        nb = H[m:n, m:n]
        H[m:n, m:n] = 0.5 * (nb + nb.T)

    def extend(self, new_dets: np.ndarray) -> None:
        """Append new determinants (none already in the basis); compute
        only their rows and columns."""
        new_dets = np.atleast_2d(np.asarray(new_dets, np.uint32))
        if len(new_dets) == 0:
            return
        m = len(self)
        n = m + len(new_dets)
        self._reserve(n)
        self._words[m:n] = to_device(new_dets, self.device)
        self._fill_new(m, n)
        self.basis = (new_dets if self.basis is None
                      else np.concatenate([self.basis, new_dets], axis=0))
        self._H_host = None
        self.peak_rows = max(self.peak_rows, n)

    @torch.no_grad()
    def restrict(self, keep: np.ndarray) -> None:
        """Prune to the given index subset (in its order)."""
        keep = np.asarray(keep)
        idx = torch.as_tensor(keep, dtype=torch.int64, device=self.device)
        k = len(keep)
        self._H[:k, :k] = self._H[idx[:, None], idx[None, :]]
        self._words[:k] = self._words[idx]
        self.basis = self.basis[keep]
        self._H_host = None


class _SortedKeyDedup:
    """Membership over uint64 keys with sorted keys and searchsorted (the
    JAX package's host code)."""

    def __init__(self):
        self.keys = np.empty(0, np.uint64)

    def filter_new(self, keys: np.ndarray) -> np.ndarray:
        """Mask of keys not yet present (first occurrence only)."""
        uniq, first = np.unique(keys, return_index=True)
        mask = np.zeros(len(keys), bool)
        if len(self.keys):
            pos = np.clip(np.searchsorted(self.keys, uniq), 0,
                          len(self.keys) - 1)
            fresh = self.keys[pos] != uniq
        else:
            fresh = np.ones(len(uniq), bool)
        mask[first[fresh]] = True
        self.keys = np.union1d(self.keys, uniq[fresh])
        return mask

    def remove_to(self, keys: np.ndarray) -> None:
        self.keys = np.sort(np.asarray(keys, np.uint64))


def _rayleigh_quotient(nqs, occ: torch.Tensor, H: torch.Tensor
                       ) -> torch.Tensor:
    """c^T H c / c^T c with c = exp(log|psi| - max)."""
    la = nqs(occ)
    c = torch.exp(la - la.max())
    return (c @ (H @ c)) / (c @ c + 1e-30)


class FlowNQSTrainer:
    """Subspace-energy NQS training with the incremental H and flow
    teaching, on the Hamiltonian's device.

    Both networks start from ``config.seed`` (a CPU generator, so every
    device starts from the same weights); samples come from a device
    generator seeded likewise."""

    def __init__(self, hamiltonian, flow, nqs,
                 config: Optional[TrainingConfig] = None):
        if hamiltonian.pack_words > 2:
            raise NotImplementedError(
                "FlowNQSTrainer dedups its basis on uint64 keys, as the JAX "
                "trainer does, which fails on the 128-bit keys of 4-word "
                "rows (more than 32 orbitals): ROADMAP.md, Queue 1, item 2 "
                "remainder (c)")
        self.h = hamiltonian
        self.config = c = config or TrainingConfig()
        self.device = hamiltonian.device
        init = torch.Generator().manual_seed(c.seed)
        flow.reset_parameters(init)
        nqs.reset_parameters(init)
        self.flow = flow.to(self.device)
        self.nqs = nqs.to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(c.seed)
        self.nqs_opt = OptaxAdamW(self.nqs.parameters(), c.nqs_lr, None,
                                  weight_decay=0.0, max_norm=c.grad_clip)
        self.flow_opt = OptaxAdamW(self.flow.parameters(), c.flow_lr, None,
                                   weight_decay=0.0, max_norm=c.grad_clip)
        self.cache = self._new_cache()
        self.dedup = _SortedKeyDedup()
        self.history: Dict[str, list] = {"energies": [], "basis_sizes": [],
                                         "epoch_times": []}

    def _new_cache(self) -> IncrementalHamiltonianCache:
        # the basis peaks at the cap plus one batch of new determinants
        c = self.config
        return IncrementalHamiltonianCache(
            self.h, capacity=min(c.max_basis_size + c.samples_per_batch,
                                 self.h.n_valid_configs))

    # ------------------------------------------------------------------

    def _occ(self) -> torch.Tensor:
        return unpack_device(self.cache.words, self.h.n_orbitals)

    @torch.no_grad()
    def _log_amplitudes(self) -> np.ndarray:
        """Host float32 log|psi| of the accumulated basis."""
        return self.nqs(self._occ()).cpu().numpy()

    def _step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Rayleigh-quotient update of the NQS, then one teacher
        update of the flow toward the updated |psi|^2; returns the energy
        before the update and the flow loss (device scalars)."""
        occ = self._occ()
        e = _rayleigh_quotient(self.nqs, occ, self.cache.H_device)
        self.nqs_opt.step(torch.autograd.grad(e, self.nqs_opt.params))
        with torch.no_grad():
            p_nqs = torch.softmax(2.0 * self.nqs(occ), 0)
        fl = -(p_nqs * self.flow.log_prob(occ)).sum()
        self.flow_opt.step(torch.autograd.grad(fl, self.flow_opt.params))
        return e.detach(), fl.detach()

    def _sample_and_accumulate(self, uniforms: Optional[tuple] = None):
        """Sample a batch from the flow and extend the cache by the
        determinants it has not seen; ``uniforms`` = (alpha, beta) (B, n)
        replaces the generator's draws."""
        c = self.config
        with torch.no_grad():
            configs, _ = self.flow.sample(
                c.samples_per_batch, float(np.float32(c.temperature)),
                generator=self.generator, uniforms=uniforms)
        occ = torch.round(configs).to(torch.int8).cpu().numpy()
        packed = pack_np(occ, self.h.n_orbitals)
        mask = self.dedup.filter_new(self.h.keys(packed))
        if mask.any():
            self.cache.extend(packed[mask])

    def _prune_if_needed(self):
        c = self.config
        if len(self.cache) <= c.max_basis_size:
            return
        la = self._log_amplitudes()
        keep_n = int(c.max_basis_size * c.prune_fraction)
        keep = np.sort(np.argsort(-la)[:keep_n])
        self.cache.restrict(keep)
        self.dedup.remove_to(self.h.keys(self.cache.basis))

    def _epoch(self, uniforms: Optional[tuple] = None) -> float:
        """Sample and accumulate, prune, step; the energy (one host
        read)."""
        self._sample_and_accumulate(uniforms)
        self._prune_if_needed()
        e, _ = self._step()
        return float(e)

    # ------------------------------------------------------------------

    def train(self) -> Dict[str, list]:
        c = self.config
        best = np.inf
        stall = 0
        for epoch in range(c.num_epochs):
            t0 = time.perf_counter()
            e = self._epoch()
            self.history["energies"].append(e)
            self.history["basis_sizes"].append(len(self.cache))
            self.history["epoch_times"].append(time.perf_counter() - t0)
            if c.verbose and epoch % 25 == 0:
                print(f"  [legacy] epoch {epoch}: E={e:.6f} "
                      f"basis={len(self.cache)}")
            if c.checkpoint_dir and epoch and epoch % c.save_interval == 0:
                self.save_checkpoint(f"{c.checkpoint_dir}/epoch_{epoch}")
            if epoch >= c.min_epochs:
                if e < best - c.convergence_threshold:
                    best, stall = e, 0
                else:
                    stall += 1
                    if stall >= c.patience:
                        break
        return self.history

    def extract_basis(self, max_size: Optional[int] = None) -> np.ndarray:
        """The accumulated determinants of largest |psi|^2 (all by
        default), in basis order."""
        order = np.argsort(-self._log_amplitudes())
        if max_size is not None:
            order = order[:max_size]
        return self.cache.basis[np.sort(order)]

    def save_checkpoint(self, path: str) -> str:
        from ..utils.checkpoint import save_checkpoint
        return save_checkpoint(path, {
            "flow_params": self.flow.state_dict(),
            "nqs_params": self.nqs.state_dict(),
            "flow_opt_state": self.flow_opt.state_dict(),
            "nqs_opt_state": self.nqs_opt.state_dict(),
            "basis": self.cache.basis,
            "rng_state": self.generator.get_state(),
            "history": {k: list(v) for k, v in self.history.items()
                        if len(v)},
        })

    def load_checkpoint(self, path: str) -> None:
        """Params, basis (its H rebuilt), generator state and history;
        the optimizer states are saved but not restored, as in the JAX
        package."""
        from ..utils.checkpoint import load_checkpoint
        st = load_checkpoint(path)
        self.flow.load_state_dict(st["flow_params"])
        self.nqs.load_state_dict(st["nqs_params"])
        self.generator.set_state(st["rng_state"])
        basis = st.get("basis")
        if basis is not None:
            basis = basis.numpy().astype(np.uint32)
            self.cache = self._new_cache()
            self.cache.extend(basis)
            self.dedup.remove_to(self.h.keys(basis))
        for k, v in st.get("history", {}).items():
            self.history[k] = list(v)


class InferenceNQSTrainer:
    """Retrain a fresh NQS on a fixed basis against its projected H (built
    once on the device), with plain Adam: on a plateau of ``patience``
    epochs the rate halves and Adam restarts, twice; the third plateau
    stops training (the JAX code; its comment says "halve LR once")."""

    def __init__(self, hamiltonian, nqs, basis: np.ndarray, lr: float = 1e-3,
                 num_epochs: int = 500, patience: int = 30, seed: int = 0):
        self.h = hamiltonian
        self.device = hamiltonian.device
        self.basis = np.atleast_2d(np.asarray(basis, np.uint32))
        self.num_epochs = num_epochs
        self.patience = patience
        cache = IncrementalHamiltonianCache(hamiltonian)
        cache.extend(self.basis)
        self.H = cache.H_device
        self.occ = unpack_device(cache.words, hamiltonian.n_orbitals)
        nqs.reset_parameters(torch.Generator().manual_seed(seed))
        self.nqs = nqs.to(self.device)
        self.lr = lr
        # (epoch, rate) at the start and after each halving
        self.lr_schedule: List[Tuple[int, float]] = []

    def _energy_and_grad(self):
        e = _rayleigh_quotient(self.nqs, self.occ, self.H)
        return e.detach(), torch.autograd.grad(e, list(self.nqs.parameters()))

    def _adam(self, lr: float, epoch: int) -> OptaxAdamW:
        self.lr_schedule.append((epoch, lr))
        return OptaxAdamW(self.nqs.parameters(), lr, None, weight_decay=0.0,
                          max_norm=float("inf"))

    def train(self) -> Dict[str, list]:
        lr = self.lr
        opt = self._adam(lr, 0)
        hist: Dict[str, list] = {"energies": []}
        best = np.inf
        stall = 0
        for epoch in range(self.num_epochs):
            e, g = self._energy_and_grad()
            opt.step(g)
            e = float(e)
            hist["energies"].append(e)
            if e < best - 1e-9:
                best, stall = e, 0
            else:
                stall += 1
                if stall >= self.patience:
                    if lr > self.lr / 4:
                        lr = lr / 2
                        opt = self._adam(lr, epoch + 1)
                        stall = 0
                    else:
                        break
        return hist
