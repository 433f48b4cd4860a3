"""Sample-based Krylov Quantum Diagonalization (stage 4), molecular path.

Counterpart of ``flow_guided_krylov_tpu/krylov/skqd.py`` for molecular
Hamiltonians evolved in the full particle-conserving space (N2/STO-3G:
1,048,576 qubit states -> 14,400 determinants):

* :class:`SampleBasedKrylovDiagonalization` — evolve the HF state by
  exp(-i dt H) on the Hamiltonian's device with an m-step Lanczos
  propagator (dense ``torch.matmul`` or the ELL SpMV kernel), sample
  each Krylov state by inverse CDF, and diagonalize H on the cumulative
  sampled bases on the host in f64.
* :class:`FlowGuidedSKQD` — combines a given basis with the Krylov bases
  and tracks variational stability.

``evolution="scipy"`` is the float64 host propagator (``expm_multiply``)
the device propagators are tested against; it runs only when named.
Nothing falls back silently: a device propagator that fails, or that
does not fit, raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..hamiltonians.base import Hamiltonian
from ..ops.ell_spmv import ell_spmv

__all__ = ["SKQDConfig", "SampleBasedKrylovDiagonalization",
           "FlowGuidedSKQD", "EvolutionBudgetError", "lanczos_expm",
           "lanczos_expm_ell"]


class EvolutionBudgetError(RuntimeError):
    """The subspace fits no device propagator in the device's memory."""


@dataclass
class SKQDConfig:
    """SKQD knobs (the JAX package's names and defaults)."""
    max_krylov_dim: int = 12
    time_step: float = 0.1
    shots_per_krylov: int = 100_000
    num_eigenvalues: int = 2
    regularization: float = 1e-8
    evolution: str = "auto"   # 'auto' | 'dense' | 'ell' | 'scipy'
    lanczos_dim: int = 30
    seed: int = 0
    verbose: bool = False


# ---------------------------------------------------------------------------
# Lanczos propagator
# ---------------------------------------------------------------------------

def _lanczos_expm_impl(mv, psi_re: torch.Tensor, psi_im: torch.Tensor,
                       dt: float, m: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(-i dt H) |psi> via an m-step Lanczos Krylov subspace.

    ``mv`` applies the real-symmetric H to a (2, N) float32 stack
    [Re; Im].  alpha/beta are real for real-symmetric H even with complex
    vectors, so T is a real tridiagonal; its (m, m) exponential comes from
    a float32 ``eigh`` and complex64 phases, as in the JAX package.
    """
    n = psi_re.shape[0]
    f32 = dict(dtype=torch.float32, device=psi_re.device)
    norm0 = torch.sqrt(torch.sum(psi_re ** 2 + psi_im ** 2))
    V_r = torch.zeros((m, n), **f32)
    V_i = torch.zeros((m, n), **f32)
    V_r[0] = psi_re / norm0
    V_i[0] = psi_im / norm0
    alphas = torch.zeros(m, **f32)
    betas = torch.zeros(m, **f32)   # betas[j] couples j and j+1

    for j in range(m):
        vr_j, vi_j = V_r[j], V_i[j]
        w = mv(torch.stack([vr_j, vi_j]))
        wr, wi = w[0], w[1]
        alpha = torch.sum(wr * vr_j + wi * vi_j)
        wr = wr - alpha * vr_j
        wi = wi - alpha * vi_j
        if j > 0:
            wr = wr - betas[j - 1] * V_r[j - 1]
            wi = wi - betas[j - 1] * V_i[j - 1]
        # full reorthogonalization against the vectors so far (m is small)
        Vr, Vi = V_r[:j + 1], V_i[:j + 1]
        proj_r = Vr @ wr + Vi @ wi          # Re<v_k|w>
        proj_i = Vr @ wi - Vi @ wr          # Im<v_k|w>
        wr = wr - (proj_r @ Vr - proj_i @ Vi)
        wi = wi - (proj_r @ Vi + proj_i @ Vr)
        beta = torch.sqrt(torch.sum(wr ** 2 + wi ** 2))
        alphas[j] = alpha
        betas[j] = beta
        # Lanczos breakdown (invariant subspace): zero the next vector so
        # T decouples and the propagator stays exact on the leading block.
        # The last step's vector has no slot (JAX drops that write).
        if j + 1 < m:
            inv = torch.where(beta > 1e-7,
                              1.0 / torch.clamp(beta, min=1e-30),
                              torch.zeros_like(beta))
            V_r[j + 1] = wr * inv
            V_i[j + 1] = wi * inv

    T = (torch.diag(alphas)
         + torch.diag(betas[:m - 1], 1)
         + torch.diag(betas[:m - 1], -1))
    evals, U = torch.linalg.eigh(T)
    phase = torch.exp(-1j * dt * evals.to(torch.complex64))
    Uc = U.to(torch.complex64)
    coeff = (Uc * phase[None, :]) @ torch.conj(Uc[0, :])
    cr = coeff.real.float()
    ci = coeff.imag.float()
    out_r = (cr @ V_r - ci @ V_i) * norm0
    out_i = (cr @ V_i + ci @ V_r) * norm0
    return out_r, out_i


def lanczos_expm(h_dense: torch.Tensor, psi_re: torch.Tensor,
                 psi_im: torch.Tensor, dt: float, m: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-H Lanczos propagator (``torch.matmul`` matvecs)."""
    return _lanczos_expm_impl(lambda v: v @ h_dense.T, psi_re, psi_im,
                              dt, m)


def lanczos_expm_ell(diag: torch.Tensor, elems: torch.Tensor,
                     tgt: torch.Tensor, psi_re: torch.Tensor,
                     psi_im: torch.Tensor, dt: float, m: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ELL Lanczos propagator over (C, N) tables: one fused ELL SpMV of
    the (2, N) [Re; Im] stack per step (``ops/ell_spmv.py``)."""
    return _lanczos_expm_impl(lambda v: ell_spmv(diag, elems, tgt, v),
                              psi_re, psi_im, dt, m)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _sample_idx_cdf(prob: torch.Tensor, uniforms: torch.Tensor
                    ) -> torch.Tensor:
    """Multinomial sampling by inverse CDF: cumsum + ``searchsorted`` of
    the uniforms in [0, 1) scaled by the total, without a (shots, dim)
    intermediate."""
    cdf = torch.cumsum(prob, 0)
    # right=True so a draw landing exactly on a cdf plateau boundary
    # (e.g. u == 0.0) can never select a zero-probability index
    idx = torch.searchsorted(cdf, uniforms * cdf[-1], right=True)
    return idx.clamp_(0, prob.shape[0] - 1)


def _sample_counts_device(psi_re: torch.Tensor, psi_im: torch.Tensor,
                          shots: int, generator: torch.Generator
                          ) -> torch.Tensor:
    u = torch.rand(shots, generator=generator, device=psi_re.device)
    idx = _sample_idx_cdf(psi_re ** 2 + psi_im ** 2, u)
    return torch.bincount(idx, minlength=psi_re.shape[0])


# ---------------------------------------------------------------------------
# SKQD
# ---------------------------------------------------------------------------

class SampleBasedKrylovDiagonalization:
    """Classical SKQD in the full particle-conserving subspace."""

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[SKQDConfig] = None,
                 initial_state: Optional[np.ndarray] = None):
        if not hasattr(hamiltonian, "n_alpha"):
            raise NotImplementedError("only molecular Hamiltonians are "
                                      "ported so far")
        self.h = hamiltonian
        self.config = config or SKQDConfig()
        self.device = hamiltonian.device
        if initial_state is None:
            initial_state = hamiltonian.get_hf_state()
        self.initial_state = np.asarray(initial_state, np.uint32)

        self.subspace = hamiltonian.enumerate_basis()         # (N, 2) uint32
        self.dim = len(self.subspace)
        self._keys = self.h.keys(self.subspace)
        self._order = np.argsort(self._keys)
        self._sorted_keys = self._keys[self._order]

        self._h_sparse: Optional[sp.csr_matrix] = None
        self._h_dense_dev: Optional[torch.Tensor] = None
        self._ell = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)

    # ------------------------------------------------------------------

    def _index_of(self, packed: np.ndarray) -> np.ndarray:
        keys = self.h.keys(np.atleast_2d(packed))
        pos = np.searchsorted(self._sorted_keys, keys)
        pos = np.clip(pos, 0, self.dim - 1)
        if not (self._sorted_keys[pos] == keys).all():
            raise ValueError("state outside the particle-conserving subspace")
        return self._order[pos]

    @property
    def subspace_hamiltonian(self) -> sp.csr_matrix:
        """Sparse subspace H (host f64), built once."""
        if self._h_sparse is None:
            self._h_sparse = self.h.to_sparse(self.subspace)
        return self._h_sparse

    def _device_hamiltonian(self) -> torch.Tensor:
        if self._h_dense_dev is None:
            self._h_dense_dev = torch.as_tensor(
                self.subspace_hamiltonian.toarray().astype(np.float32),
                device=self.device)
        return self._h_dense_dev

    def _dense_evolution_cap(self) -> int:
        """Max subspace dim for the dense device propagator.  The 20,000
        row ceiling is the JAX package's dense/ELL crossover, measured on
        a TPU; it has not been measured on a GPU."""
        from ..utils.memory import MemoryBudget
        return min(MemoryBudget.for_device(self.device)
                   .dense_hamiltonian_cap(), 20_000)

    def _ell_fits_memory(self) -> bool:
        """True when the fixed-degree (index, element) table of the
        subspace fits the connection-table budget."""
        from ..utils.memory import MemoryBudget
        entries = self.dim * (self.h.n_connections + 1)
        return entries <= (MemoryBudget.for_device(self.device)
                           .connection_table_entries())

    # ------------------------------------------------------------------
    # Time evolution
    # ------------------------------------------------------------------

    def _evolve_scipy(self, psi: np.ndarray) -> np.ndarray:
        """Float64 host propagator (scipy ``expm_multiply``)."""
        H = self.subspace_hamiltonian
        return spla.expm_multiply(-1j * self.config.time_step * H, psi)

    def _psi_to_device(self, psi: np.ndarray):
        return (torch.as_tensor(np.real(psi).astype(np.float32),
                                device=self.device),
                torch.as_tensor(np.imag(psi).astype(np.float32),
                                device=self.device))

    def _evolve_device(self, psi: np.ndarray) -> np.ndarray:
        re, im = self._psi_to_device(psi)
        out_r, out_i = lanczos_expm(self._device_hamiltonian(), re, im,
                                    self.config.time_step,
                                    min(self.config.lanczos_dim, self.dim))
        return out_r.cpu().numpy() + 1j * out_i.cpu().numpy()

    def _ell_structure(self):
        """ELL (diag, elems_t, target_idx_t) on the device, tables in the
        (C, N) layout of ``ops/ell_spmv.py``, built from the full-space
        connection table."""
        if self._ell is None:
            from ..utils.connection_table import build_connection_table
            from ..utils.memory import MemoryBudget
            budget = MemoryBudget.for_device(self.device)
            t = build_connection_table(
                self.h, max_entries=budget.connection_table_entries())
            if t is None:
                raise EvolutionBudgetError(
                    f"ELL table of {self.dim} x {self.h.n_connections} "
                    f"entries exceeds the memory budget")
            self._ell = (t.diag, t.elems.T.contiguous(),
                         t.target_idx.T.contiguous())
        return self._ell

    def _evolve_device_ell(self, psi: np.ndarray) -> np.ndarray:
        diag, elems, tgt = self._ell_structure()
        re, im = self._psi_to_device(psi)
        out_r, out_i = lanczos_expm_ell(
            diag, elems, tgt, re, im, self.config.time_step,
            min(self.config.lanczos_dim, self.dim))
        return out_r.cpu().numpy() + 1j * out_i.cpu().numpy()

    def evolve(self, psi: np.ndarray) -> np.ndarray:
        """exp(-i dt H) psi for a host complex vector over the subspace.

        ``auto`` picks a device propagator (dense, then ELL) and raises
        :class:`EvolutionBudgetError` when neither fits the device's
        memory; the host propagator runs only when asked for by name."""
        mode = self.config.evolution
        if self.dim <= 1:
            mode = "scipy"
        if mode == "auto":
            if self.dim <= self._dense_evolution_cap():
                mode = "dense"
            elif self._ell_fits_memory():
                mode = "ell"
            else:
                raise EvolutionBudgetError(
                    f"subspace of {self.dim} dets fits neither the dense "
                    f"nor the ELL propagator on {self.device}; set "
                    f"evolution='scipy' to evolve on the host")
        if mode == "ell":
            return self._evolve_device_ell(psi)
        if mode == "dense":
            return self._evolve_device(psi)
        if mode == "scipy":
            return self._evolve_scipy(psi)
        raise ValueError(f"unknown evolution mode {mode!r}")

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    def sample_state(self, psi: np.ndarray, shots: int) -> Dict[int, int]:
        """Measurement counts {subspace_index: count}."""
        re, im = self._psi_to_device(psi)
        counts = _sample_counts_device(re, im, shots,
                                       self.generator).cpu().numpy()
        nz = np.nonzero(counts)[0]
        return {int(i): int(counts[i]) for i in nz}

    def generate_krylov_samples(self) -> List[Dict[int, int]]:
        """Sample at every Krylov step k=0..K-1, evolving in between."""
        c = self.config
        psi = np.zeros(self.dim, dtype=np.complex128)
        psi[self._index_of(self.initial_state)[0]] = 1.0
        samples = []
        for k in range(c.max_krylov_dim):
            samples.append(self.sample_state(psi, c.shots_per_krylov))
            if k < c.max_krylov_dim - 1:
                psi = self.evolve(psi)
                psi = psi / np.linalg.norm(psi)
        return samples

    def build_cumulative_basis(self, samples: List[Dict[int, int]]
                               ) -> List[np.ndarray]:
        """Running union of sampled configs per Krylov dimension."""
        seen: Dict[int, int] = {}
        bases = []
        for counts in samples:
            for idx, ct in counts.items():
                seen[idx] = seen.get(idx, 0) + ct
            idxs = np.sort(np.fromiter(seen.keys(), dtype=np.int64))
            bases.append(self.subspace[idxs])
        return bases

    # ------------------------------------------------------------------
    # Projected eigensolve with stability guardrails
    # ------------------------------------------------------------------

    def compute_ground_state_energy(self, basis: np.ndarray) -> float:
        """Project H on ``basis`` and diagonalize (host f64): Hermitize,
        regularize, condition check -> SVD fallback, dense/sparse routing."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        nb = len(basis)
        reg = self.config.regularization

        if nb > 2048:
            M = self.h.to_sparse(basis)
            M = (M + M.T) * 0.5 + reg * sp.eye(nb)
            k = min(self.config.num_eigenvalues, nb - 1)
            try:
                vals = spla.eigsh(M, k=max(k, 1), which="SA",
                                  return_eigenvectors=False)
            except spla.ArpackNoConvergence:
                vals = np.linalg.eigvalsh(M.toarray())
            return float(vals.min() - reg)

        H = self.h.matrix_elements(basis, basis)
        H = 0.5 * (H + H.T) + reg * np.eye(nb)
        cond = np.linalg.cond(H) if nb > 1 else 1.0
        if not np.isfinite(cond) or cond > 1e12:
            # SVD fallback with singular-value clamping
            u, s, vt = np.linalg.svd(H)
            s = np.maximum(s, 1e-10)
            H = u @ np.diag(s) @ vt
            H = 0.5 * (H + H.T)
        return float(np.linalg.eigvalsh(H)[0] - reg)


class FlowGuidedSKQD(SampleBasedKrylovDiagonalization):
    """SKQD combined with a given (flow- or Selected-CI-found) basis."""

    def __init__(self, hamiltonian: Hamiltonian, nf_basis: np.ndarray,
                 config: Optional[SKQDConfig] = None,
                 initial_state: Optional[np.ndarray] = None):
        super().__init__(hamiltonian, config, initial_state)
        self.nf_basis = np.atleast_2d(np.asarray(nf_basis, np.uint32))

    def get_combined_basis(self, krylov_basis: np.ndarray) -> np.ndarray:
        """unique(NF union Krylov), first occurrence order."""
        both = np.concatenate([self.nf_basis, krylov_basis], axis=0)
        _, idx = np.unique(self.h.keys(both), return_index=True)
        return both[np.sort(idx)]

    # above this NF-basis size only the final cumulative union is
    # diagonalized (each per-k solve is a fresh CSR build + ARPACK)
    FINAL_ONLY_NF_ROWS = 100_000

    def run_with_nf(self) -> Dict:
        """Per-k Krylov-only vs combined energies with variational
        monotonicity checks and best-stable tracking."""
        c = self.config
        final_only = len(self.nf_basis) > self.FINAL_ONLY_NF_ROWS
        nf_energy = self.compute_ground_state_energy(self.nf_basis)

        samples = self.generate_krylov_samples()
        bases = self.build_cumulative_basis(samples)

        krylov_energies: List[float] = []
        combined_energies: List[float] = []
        combined_sizes: List[int] = []
        instabilities: List[int] = []
        best_stable = nf_energy
        prev_combined = nf_energy

        for k, kb in enumerate(bases):
            if final_only and k < len(bases) - 1:
                continue
            e_k = self.compute_ground_state_energy(kb)
            combined = self.get_combined_basis(kb)
            e_c = self.compute_ground_state_energy(combined)
            krylov_energies.append(e_k)
            combined_energies.append(e_c)
            combined_sizes.append(len(combined))

            rise = e_c - prev_combined
            jump = abs(e_c - prev_combined)
            stable = not (rise > 1e-3 or jump > 1.0)
            if not stable:
                instabilities.append(k)
                if c.verbose:
                    print(f"  [skqd] instability at k={k}: "
                          f"E_combined={e_c:.6f} (prev {prev_combined:.6f})")
            else:
                best_stable = min(best_stable, e_c)
            prev_combined = e_c

        return {
            "nf_only_energy": nf_energy,
            "nf_basis_size": int(len(self.nf_basis)),
            "krylov_energies": krylov_energies,
            "combined_energies": combined_energies,
            "combined_sizes": combined_sizes,
            "krylov_basis_sizes": [len(b) for b in bases],
            "krylov_bases": bases,
            "instabilities": instabilities,
            "best_stable_energy": float(best_stable),
            "final_energy": float(best_stable),
        }
