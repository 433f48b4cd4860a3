"""Sample-based Krylov Quantum Diagonalization (stage 4).

Counterpart of ``flow_guided_krylov_tpu/krylov/skqd.py`` for two paths:

* molecular Hamiltonians evolved in the full particle-conserving space
  (N2/STO-3G: 1,048,576 qubit states -> 14,400 determinants) by an m-step
  Lanczos propagator on the Hamiltonian's device (dense ``torch.matmul``
  or the ELL SpMV kernel);
* spin lattices of up to 31 sites.  Past ``trotter_threshold`` sites (or
  with ``evolution="trotter"``) a full 2^n statevector is evolved on the
  device by a second-order Trotter splitting over the Hamiltonian's Pauli
  words, all of them through the x_sweep kernel (a contiguous tile for
  the low-bit words, gathered tiles for the rest).  Smaller lattices,
  and magnetization-conserving ones whose sector's ELL table fits the
  device, evolve in an enumerated subspace with the dense, ELL or scipy
  propagator;
* any given set of packed states (``subspace_states=``): restricted SKQD,
  the stage-4 route for molecules whose full space is beyond enumeration
  (:func:`build_restricted_subspace`).

Sector and restricted ELL tables are built on the device
(:meth:`SampleBasedKrylovDiagonalization._build_ell_device`), and
:meth:`SampleBasedKrylovDiagonalization.exact_subspace_energy` is the
oracle of an enumerated subspace.

:class:`SampleBasedKrylovDiagonalization` samples each Krylov state by
inverse CDF and diagonalizes H on the cumulative sampled bases on the host
in f64.  :class:`FlowGuidedSKQD` combines a given basis with the Krylov
bases and tracks variational stability.

``evolution="scipy"`` is the float64 host propagator (``expm_multiply``)
the device propagators are tested against; it runs only when named.
Nothing falls back silently: a device propagator that fails, or that
does not fit, raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from math import comb
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..hamiltonians.base import Hamiltonian, _KeyIndex, lowest_pairs
from ..hamiltonians.spin import extract_coeffs_and_paulis
from ..ops.bits import to_device
from ..ops.ell_spmv import ell_spmv
from ..ops.x_sweep import (PHASE_LOAD, PHASE_STORE, TILE_BITS, _pauli_masks,
                           half_phase_angles, half_phase_classes,
                           make_gathered_sweeps, phase_table)
from ..ops.x_sweep import diag_mul as _diag_mul
from ..utils.profiling import count, span

__all__ = ["SKQDConfig", "SampleBasedKrylovDiagonalization",
           "FlowGuidedSKQD", "EvolutionBudgetError", "lanczos_expm",
           "lanczos_expm_ell", "supported_evolution_dim",
           "build_restricted_subspace"]


class EvolutionBudgetError(RuntimeError):
    """The subspace fits no device propagator in the device's memory."""


def _evolution_rows(h: Hamiltonian, mesh=None) -> Tuple[int, int]:
    """(dense rows, ELL rows): the largest subspaces the dense and the ELL
    device propagators hold on ``h.device``.  Dense rows are capped at the
    JAX package's 20,000-row crossover (see :meth:`
    SampleBasedKrylovDiagonalization._dense_evolution_cap`); ELL rows are
    the connection-table entry budget over ``n_connections + 1`` entries
    a row.

    A mesh row-shards both: dense rows scale by sqrt(d), ELL entries by
    d, d counting physical devices only (a logical mesh on one card gains
    nothing).  The JAX package's 0.9 GB ``program_safe_entries`` cap was
    a limit of its TPU worker and is not carried."""
    from ..utils.memory import MemoryBudget
    n_dev = mesh.n_physical if mesh is not None else 1
    budget = MemoryBudget.for_device(h.device)
    dense = int(min(budget.dense_hamiltonian_cap(), 20_000) * np.sqrt(n_dev))
    ell = budget.connection_table_entries() * n_dev // (h.n_connections + 1)
    return dense, int(ell)


def supported_evolution_dim(h: Hamiltonian, mesh=None) -> int:
    """Largest subspace dimension that ``evolve(auto)`` can propagate on
    ``h.device``, dense or ELL (:func:`_evolution_rows`).  The pipeline's
    stage-4 routing reads it."""
    return max(_evolution_rows(h, mesh))


def build_restricted_subspace(h: Hamiltonian, basis: np.ndarray, cap: int,
                              initial_state: Optional[np.ndarray] = None,
                              mesh=None) -> np.ndarray:
    """Evolution subspace for restricted molecular SKQD: the given basis
    plus its top PT2-ranked external candidates, at most ``cap`` states.

    The propagator then acts within (basis + strongest externals), so time
    evolution still moves amplitude into determinants the variational
    stages missed, at any system size.  The build is the span
    ``skqd.restrict``."""
    with span("skqd.restrict"):
        from .residual_expansion import (ResidualExpansionConfig,
                                         SelectedCIExpander)
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        cap = int(cap)
        exp = SelectedCIExpander(
            h, ResidualExpansionConfig(max_basis_size=cap), mesh=mesh)
        rows = []
        if initial_state is not None:
            rows.append(np.atleast_2d(np.asarray(initial_state,
                                                 np.uint32)))
        n_init = sum(len(r) for r in rows)
        if len(basis) + n_init > cap:
            # the basis alone overflows the propagator: keep its top-|c|
            # rows
            _, coeffs = exp._diagonalize(basis)
            keep = np.argsort(-np.abs(coeffs))[:max(1, cap - n_init)]
            rows.append(basis[np.sort(keep)])
        else:
            rows.append(basis)
            room = cap - len(basis) - n_init
            if room > 0:
                cand, scores, _, _ = exp.rank_external_candidates(basis)
                if len(cand):
                    top = cand[np.argsort(-scores)[:room]]
                    rows.append(np.asarray(top, np.uint32))
        states = np.concatenate(rows, axis=0)
        _, first = np.unique(h.keys(states), return_index=True)
        return states[np.sort(first)]


@dataclass
class SKQDConfig:
    """SKQD knobs (the JAX package's names and defaults)."""
    max_krylov_dim: int = 12
    time_step: float = 0.1
    num_trotter_steps: int = 8          # Trotter substeps per evolve
    shots_per_krylov: int = 100_000
    # declared by the JAX package and read nowhere there: the Krylov bases
    # are always cumulative (build_cumulative_basis); carried for config
    # parity
    use_cumulative_basis: bool = True
    regularization: float = 1e-8
    # False evolves on the host (the 'scipy' propagator), whatever
    # ``evolution`` says; Trotter mode has no host propagator
    use_device_evolution: bool = True
    evolution: str = "auto"   # 'auto' | 'dense' | 'ell' | 'scipy' | 'trotter'
    lanczos_dim: int = 30
    # spin systems beyond this many sites evolve a full 2^n statevector
    # with second-order Trotter over Pauli words instead of building the
    # subspace Hamiltonian on the host
    trotter_threshold: int = 17
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
    a float32 ``eigh`` and complex64 phases, as in the JAX package.  On an
    H100 an evolve over N2/cc-pVDZ's 30,513-state restricted
    subspace (|T| ~ 109 Ha) came within 1.76e-6 of scipy's f64
    ``expm_multiply`` (relative 2-norm; a float64 ``eigh`` gave 1.54e-6,
    the float32 Krylov vectors' floor), under the 1e-5 past which the
    tridiagonal would need float64.  ``chip_smoke.py`` measures the gap
    every run.
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

# probabilities per row of the sampler's two-level cdf
_CDF_ROW = 4096


def _sample_idx_cdf(prob: torch.Tensor, uniforms: torch.Tensor
                    ) -> torch.Tensor:
    """Multinomial sampling by inverse CDF: cumsum + ``searchsorted`` of
    the uniforms in [0, 1) scaled by the total, without a (shots, dim)
    intermediate.

    The cdf is summed in a fixed order, so one seed draws the same
    indices on every run: rows of ``_CDF_ROW`` probabilities are scanned
    along their last axis, and the row totals are prefixed in float64 on
    the host.  A 1-D CUDA ``cumsum`` of float32 is not reproducible: its
    block-wise scan adds the blocks' carries in whatever order they
    finish."""
    n = prob.shape[0]
    # zero-padded to two rows or more: a single row would be a 1-D scan
    pad = -n % _CDF_ROW + (_CDF_ROW if n <= _CDF_ROW else 0)
    rows = torch.nn.functional.pad(prob, (0, pad))
    rows = torch.cumsum(rows.view(-1, _CDF_ROW), 1)
    ends = np.cumsum(rows[:, -1].double().cpu().numpy())
    starts = torch.as_tensor(np.concatenate([[0.0], ends[:-1]]),
                             device=prob.device)
    cdf = (rows.double() + starts[:, None]).view(-1)[:n]
    # the uniforms scale in float32, as the JAX package's sampler does;
    # right=True so a draw landing exactly on a cdf plateau boundary
    # (e.g. u == 0.0) can never select a zero-probability index
    target = uniforms * cdf[-1].float()
    idx = torch.searchsorted(cdf, target.double(), right=True)
    return idx.clamp_(0, n - 1)


def _sample_counts_device(psi_re: torch.Tensor, psi_im: torch.Tensor,
                          shots: int, generator: torch.Generator
                          ) -> torch.Tensor:
    u = torch.rand(shots, generator=generator, device=psi_re.device)
    idx = _sample_idx_cdf(psi_re ** 2 + psi_im ** 2, u)
    return torch.bincount(idx, minlength=psi_re.shape[0])


# ---------------------------------------------------------------------------
# Spin subspaces and the statevector Trotter propagator
# ---------------------------------------------------------------------------

def _sector_states(n: int, k: int) -> np.ndarray:
    """All n-bit states with popcount k, sorted (the fixed-magnetization
    sector of a conserving spin Hamiltonian).

    Pascal recursion: states(m, j) = states(m-1, j) followed by
    states(m-1, j-1) | 1<<(m-1); both halves ascend and the second lies
    above the first, so the result is sorted by construction."""
    prev = {0: np.zeros(1, dtype=np.uint32)}          # m = 0
    for m in range(1, n + 1):
        cur = {}
        for j in range(max(0, k - (n - m)), min(k, m) + 1):
            parts = []
            if j in prev:
                parts.append(prev[j])
            if j - 1 in prev:
                parts.append(prev[j - 1] + np.uint32(1 << (m - 1)))
            cur[j] = parts[0] if len(parts) == 1 else np.concatenate(parts)
        prev = cur
    if len(prev[k]) != comb(n, k):
        raise AssertionError(f"sector ({n}, {k}) has {len(prev[k])} states")
    return prev[k]


def _half_phase(diag: List[Tuple[float, int]], n: int, dt_sub: float,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(-i dt_sub/2 * D) as a (cos, -sin) float32 pair over the 2^n
    states, where D = sum_w c_w (-1)^popcount(k & z_w) sums the diagonal
    words (c_w, z_w).

    The float32 angles are summed on the device; the cos and sin of each
    distinct angle are taken in float64 on the host and rounded to
    float32, as for the rotation angles (``ops/x_sweep._cos_sin_f32``).
    The phase is then the same on every device, so a Trotter evolve on
    the card equals the plain one on the CPU bit for bit, and no
    library's float32 ``cos`` enters it.  On a card the substep takes the
    same phase in compact form (``ops/x_sweep.half_phase_classes``) unless
    it has too many distinct angles."""
    ang, where = torch.unique(half_phase_angles(diag, n, dt_sub, device),
                              return_inverse=True)
    table = phase_table(ang.cpu().numpy(), device)
    return table[:, 0][where], table[:, 1][where]


def _fuses_half_phase(device) -> bool:
    """Whether a Trotter substep applies its half-phase inside its first
    and last sweep launches: on a card.  On the CPU it stays the plain
    chain of :func:`_half_phase` tables and :func:`_diag_mul`."""
    return torch.device(device).type == "cuda"


def _fused_substep(steps, phase):
    """diag . sweeps . diag with the leading half-phase inside the first
    launch and the trailing one inside the last: two half-phase products,
    as the chain has, never one full-phase product.  ``parts`` lists the
    launches, so an evolve runs them one by one."""
    last = len(steps) - 1
    parts = []
    for i, step in enumerate(steps):
        at = (PHASE_LOAD if i == 0 else 0) | (PHASE_STORE if i == last else 0)
        parts.append(functools.partial(step, phase=phase, at=at) if at
                     else step)

    def substep(re, im):
        for part in parts:
            re, im = part(re, im)
        return re, im

    substep.parts = parts
    return substep


def _half_angle_words(offd, dt_sub: float):
    """Every (c, x_mask, z_mask, n_y) term of ``offd`` at half angle
    c * dt_sub / 2, then the same list reversed: a second-order substep's
    words for any terms, and the mesh's (``parallel/sharded_trotter``)."""
    seq = [(c * dt_sub / 2, xm, zm, ny) for c, xm, zm, ny in offd]
    return seq + seq[::-1]


def _substep_words(offd, dt_sub: float):
    """(words, commuting): the off-diagonal word list of one substep.

    When every term of ``offd`` commutes with every other (the symplectic
    product popcount((x1 & z2) ^ (z1 & x2)) even), the forward and
    reversed half-angle products are one product of commuting
    exponentials, so each distinct word is applied once at its full angle
    c * dt_sub, the angles of a repeated word summed, in the order of its
    first appearance.  Otherwise the list is :func:`_half_angle_words`."""
    commuting = all(((x1 & z2) ^ (z1 & x2)).bit_count() % 2 == 0
                    for i, (_, x1, z1, _) in enumerate(offd)
                    for _, x2, z2, _ in offd[i + 1:])
    if not commuting:
        return _half_angle_words(offd, dt_sub), False
    angles = {}
    for c, xm, zm, ny in offd:
        angles[xm, zm, ny] = angles.get((xm, zm, ny), 0.0) + c * dt_sub
    return [(theta,) + key for key, theta in angles.items()], True


# ---------------------------------------------------------------------------
# SKQD
# ---------------------------------------------------------------------------

class SampleBasedKrylovDiagonalization:
    """Classical SKQD: in the particle-conserving subspace for molecules;
    in the magnetization sector, the full space, or (past
    ``trotter_threshold`` sites) a Trotterized statevector for spins; or
    within the given ``subspace_states`` (restricted SKQD).

    ``mesh`` (``parallel.make_mesh``; its first device the Hamiltonian's)
    row-shards the dense and ELL propagators' H over its entries and
    holds a Trotter statevector as one block an entry
    (``parallel/``); the Lanczos vectors and the sampling stay on the
    first device."""

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[SKQDConfig] = None,
                 initial_state: Optional[np.ndarray] = None,
                 mesh=None, subspace_states: Optional[np.ndarray] = None):
        self.h = hamiltonian
        self.config = config or SKQDConfig()
        self.device = hamiltonian.device
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import canonical
            if canonical(mesh.first) != canonical(self.device):
                raise ValueError(f"the mesh's first device {mesh.first} "
                                 f"must be the Hamiltonian's {self.device}")
        self.is_molecular = hasattr(hamiltonian, "n_alpha")
        if not self.is_molecular and hamiltonian.pack_words > 1:
            raise NotImplementedError(
                "SKQD on more than 31 spins (two words a configuration): "
                "the JAX package has no such path (it packs the Neel state "
                "into one uint32, and its run_large_spin_sci goes to "
                "Selected-CI), so the port does not carry it (ROADMAP.md, "
                "item 2 remainder (b))")
        # an explicit evolution subspace (restricted SKQD): evolve within
        # the given packed states, not the enumerated full space
        self.restricted = subspace_states is not None
        # initial state: HF for molecules, Neel for spins
        if initial_state is None:
            if self.is_molecular:
                initial_state = hamiltonian.get_hf_state()
            else:
                neel = sum(1 << i for i in range(0, hamiltonian.n_sites, 2))
                initial_state = np.array([neel], dtype=np.uint32)
        self.initial_state = np.asarray(initial_state, np.uint32)

        # Magnetization-conserving spin systems (XXZ without transverse
        # fields) evolve inside the fixed-popcount sector of the initial
        # state, the spin analog of the particle-conserving subspace.
        self._sector_n_up: Optional[int] = None
        if (not self.is_molecular
                and getattr(hamiltonian, "conserves_magnetization", False)):
            self._sector_n_up = int(
                bin(int(self.initial_state.reshape(-1)[0])).count("1"))

        # Large spin systems evolve a full 2^n statevector with Trotterized
        # Pauli rotations instead of enumerating the space and building a
        # subspace Hamiltonian: 2^24 (re, im) float32 amplitudes take
        # 128 MB, where the sparse H would hold 2^24 * n_sites entries.
        # Trotter error only perturbs which configurations are sampled;
        # the projected eigensolve is exact either way.  A conserved
        # sector small enough to enumerate stays on the subspace path.
        c = self.config
        n_sites = getattr(hamiltonian, "n_sites", 0)
        sector_small = False
        if self._sector_n_up is not None:
            from ..utils.memory import MemoryBudget
            sector_dim = comb(n_sites, self._sector_n_up)
            sector_small = (
                sector_dim <= (1 << c.trotter_threshold)
                or sector_dim * (hamiltonian.n_connections + 1)
                <= MemoryBudget.for_device(self.device)
                .connection_table_entries())
        self.use_trotter = (not self.is_molecular) and (
            c.evolution == "trotter"
            or (c.evolution == "auto" and n_sites > c.trotter_threshold
                and not sector_small))

        if self.restricted:
            self.use_trotter = False
        if self.use_trotter:
            self.subspace = None
            self.dim = 1 << n_sites
            self._keys = self._order = self._sorted_keys = None
        else:
            if self.restricted:
                self.subspace = np.atleast_2d(
                    np.asarray(subspace_states, np.uint32))
            elif self.is_molecular:
                self.subspace = hamiltonian.enumerate_basis()  # (N, 2)
            elif self._sector_n_up is not None:
                self.subspace = _sector_states(
                    n_sites, self._sector_n_up)[:, None]      # (N, 1)
            else:
                self.subspace = np.arange(
                    1 << n_sites, dtype=np.uint32)[:, None]   # (N, 1)
            self.dim = len(self.subspace)
            self._keys = self.h.keys(self.subspace)
            self._order = np.argsort(self._keys)
            self._sorted_keys = self._keys[self._order]

        self._h_sparse: Optional[sp.csr_matrix] = None
        self._h_dense_dev: Optional[torch.Tensor] = None
        self._ell = None
        self._trotter = None
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
        if self.subspace is None:
            raise RuntimeError(
                "Trotter mode never builds the subspace Hamiltonian "
                f"(2^{self.h.n_sites} states); use the statevector path")
        if self._h_sparse is None:
            self._h_sparse = self.h.to_sparse(self.subspace)
        return self._h_sparse

    def _device_hamiltonian(self):
        """The dense float32 subspace H on the device, or with a mesh its
        row blocks (``parallel.shard_hamiltonian_rows``: zero rows pad it
        to a multiple of the mesh's size)."""
        if self._h_dense_dev is None:
            h_np = self.subspace_hamiltonian.toarray().astype(np.float32)
            if self.mesh is not None:
                from ..parallel.sharded_matvec import shard_hamiltonian_rows
                self._h_dense_dev = shard_hamiltonian_rows(self.mesh, h_np)
            else:
                self._h_dense_dev = torch.as_tensor(h_np, device=self.device)
        return self._h_dense_dev

    def _dense_evolution_cap(self) -> int:
        """Max subspace dim for the dense device propagator.  The 20,000
        row ceiling is the JAX package's dense/ELL crossover.  On an H100
        no single row count separates the two: a warm 30-step evolve is
        launch-bound either way (14-52 ms), dense ahead at 5,000-10,000
        rows of 2,835 connections, ELL ahead at 14,400 rows of 609 and,
        twofold, at 30,513 rows of 2,835 (``chip_smoke.py``), so the
        ceiling stays.  A mesh raises it by sqrt(physical devices)."""
        return _evolution_rows(self.h, self.mesh)[0]

    def _ell_fits_memory(self) -> bool:
        """True when the fixed-degree (index, element) table of the
        subspace fits the connection-table budget (times the mesh's
        physical devices: the rows shard over them)."""
        return self.dim <= _evolution_rows(self.h, self.mesh)[1]

    # ------------------------------------------------------------------
    # Statevector Trotter propagator (large spin systems)
    # ------------------------------------------------------------------

    def _trotter_ops(self):
        """One second-order Trotter substep over the Hamiltonian's Pauli
        words, built once: diag . sweeps(words) . diag.

        * diag: every diagonal word (x_mask == 0) folds into one
          half-phase exp(-i dt/2 * D).  On a card it is a class index of
          one byte a state and a (cos, -sin) table of the distinct
          angles, applied inside the first sweep launch after its load
          and inside the last before its store (``trotter.phase_classes``
          counts the angles).  Past 256 distinct angles
          (``trotter.phase_fallback``), and on the CPU,
          it is a (cos, -sin) float32 pair of 2^n tables applied by
          :func:`_diag_mul` around the sweeps.  Both round alike, so the
          states are equal bit for bit.
        * words: the off-diagonal words, first those whose x_mask lies
          inside the contiguous tile, 0 < x_mask < 2^min(TILE_BITS, n)
          (low), then the others (high); ``plan_sweeps`` cuts the list,
          without reordering, into gathered-tile sweeps
          (``trotter.substep_launches`` counts them).  When every word
          commutes with every other (TFIM's single-site X's), the list is
          each distinct word once at its full angle
          (``trotter.commuting_words``; :func:`_substep_words`): three
          launches at TFIM-28 (bits 0..13, {0..3, 14..23}, {0..9,
          24..27}), two from 15 to 24 sites.  This equals the forward and
          reversed half-angle product in exact arithmetic.  Otherwise it
          is that product: the words at half angle, then the same list
          reversed.  On the CPU the list is the same chain of
          ``_pauli_rotation_pair`` calls.

        Both lists are second order for any order of the words.  The JAX
        package applies the forward and reversed half-angle list for
        every model.
        """
        if self._trotter is None:
            with span("skqd.trotter_build", sync=True):
                self._trotter = self._build_trotter_ops()
        return self._trotter

    def _build_trotter_ops(self):
        coeffs, words = extract_coeffs_and_paulis(self.h)
        n = self.h.n_sites
        masks = [_pauli_masks(w) for w in words]
        dt_sub = self.config.time_step / max(self.config.num_trotter_steps, 1)
        diag = [(c, zm) for c, (xm, zm, _) in zip(coeffs, masks) if xm == 0]
        offd = [(c, xm, zm, ny)
                for c, (xm, zm, ny) in zip(coeffs, masks) if xm != 0]
        tile = 1 << min(TILE_BITS, n)
        offd = ([w for w in offd if w[1] < tile]
                + [w for w in offd if w[1] >= tile])
        if self._sharded_statevector():
            # one block an entry: in-block words through per-block x_sweep
            # tables, the others by block exchange (parallel/sharded_trotter)
            from ..parallel.sharded_trotter import make_sharded_substep
            step, hr, hi = make_sharded_substep(self.mesh, n, diag, offd,
                                                dt_sub)

            def sharded(re, im):
                return step(re, im, hr, hi)

            sharded.block_runs = step.block_runs
            return sharded
        words, commuting = _substep_words(offd, dt_sub)
        sweeps = make_gathered_sweeps(n, words)
        if _fuses_half_phase(self.device) and sweeps.steps:
            phase = half_phase_classes(diag, n, dt_sub, self.device)
            if phase is not None:
                count("trotter.phase_classes", phase.table.shape[0])
                if commuting:
                    count("trotter.commuting_words", len(words))
                count("trotter.substep_launches", len(sweeps.steps))
                return _fused_substep(sweeps.steps, phase)
            count("trotter.phase_fallback")
        hp_re, hp_im = _half_phase(diag, n, dt_sub, self.device)

        def substep(re, im):
            re, im = _diag_mul(re, im, hp_re, hp_im)
            re, im = sweeps(re, im)
            return _diag_mul(re, im, hp_re, hp_im)

        return substep

    def _sharded_statevector(self) -> bool:
        from ..parallel.sharded_trotter import mesh_supports_statevector
        return (self.mesh is not None
                and mesh_supports_statevector(self.mesh, self.h.n_sites))

    def _evolve_trotter(self, re, im):
        """exp(-i dt H) on a device (re, im) statevector pair, in
        ``num_trotter_steps`` substeps; with a mesh the pair is two lists
        of blocks (``parallel.shard_statevector``)."""
        with span("skqd.evolve", sync=True):
            substep = self._trotter_ops()
            # launch by launch where the substep lists them, so that no
            # frame here keeps a pair a launch has consumed
            parts = getattr(substep, "parts", (substep,))
            for _ in range(max(self.config.num_trotter_steps, 1)):
                for part in parts:
                    re, im = part(re, im)
        return re, im

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
        """Dense Lanczos propagator; with a mesh its matvec is row-sharded
        and the vectors keep the subspace's length (the padding rows never
        reach them)."""
        re, im = self._psi_to_device(psi)
        H = self._device_hamiltonian()
        m = min(self.config.lanczos_dim, self.dim)
        if self.mesh is not None:
            from ..parallel.sharded_matvec import sharded_lanczos_expm
            out_r, out_i = sharded_lanczos_expm(
                self.mesh, H, re, im, self.config.time_step, m)
        else:
            out_r, out_i = lanczos_expm(H, re, im, self.config.time_step, m)
        return out_r.cpu().numpy() + 1j * out_i.cpu().numpy()

    def _build_ell_device(self, states: np.ndarray,
                          chunk: Optional[int] = None, mesh=None):
        """(diag (N,), elems_t (C, N), tgt_t (C, N)) of H restricted to
        the packed ``states``, built on the device: only the states cross
        the host link.  A connection's target is found by ``searchsorted``
        over the states' sorted int64 keys (``Hamiltonian.keys_device``,
        which orders like the host ``keys``); a connection that leaves the
        set gets element 0 and target 0.  Works for any state set: a
        conserved sector, a sampled Krylov basis, a PT2-ranked restricted
        molecular subspace.

        4-word determinants key as (alpha, beta) int64 pairs
        (``hamiltonians.base._KeyIndex`` over ``_PairKeys``): each
        channel's key is ranked among the set's
        distinct keys of that channel, and the pair searches as the one
        int64 ``rank_a * n_beta + rank_b``, which orders the set as the
        lexicographic pair order does.

        ``chunk`` rows are worked at a time (sized from the memory budget
        and C when None) and written, transposed, into column slices of
        the preallocated (C, N) tables: the finished tables are the only
        table-sized allocation.  With a ``mesh`` the tables are its row
        blocks (``parallel.ShardedEll``: zero rows pad them to a multiple
        of the mesh's size), each allocated on its entry's device and
        built there chunk by chunk by the Hamiltonian's replica on that
        device (``Hamiltonian.on``), so no device holds more than its own
        block, the search keys and one chunk, and only the keys are
        copied between devices.

        The build is the span ``skqd.ell_build`` (synchronized); the
        counters ``ell.rows`` and ``ell.entries`` add N and N x C."""
        with span("skqd.ell_build", sync=True):
            out = self._ell_tables(states, chunk, mesh)
        count("ell.rows", len(states))
        count("ell.entries", len(states) * self.h.n_connections)
        return out

    def _ell_tables(self, states: np.ndarray, chunk: Optional[int],
                    mesh):
        from ..utils.memory import MemoryBudget
        states = np.atleast_2d(np.asarray(states, np.uint32))
        dim = len(states)
        if dim > 2 ** 31 - 1:
            raise ValueError(f"{dim} rows do not fit the tables' int32 "
                             "target indices")
        C = self.h.n_connections
        dev = self.device
        if chunk is None:
            chunk = MemoryBudget.for_device(dev).build_chunk_rows(C)
        index = _KeyIndex(self.h.keys_device(to_device(states, dev)),
                          torch.int32)
        if mesh is None:
            spans, pad = [(0, dim, dev)], 0
        else:
            from ..parallel.mesh import blocks_of, split_rows
            _, pad = split_rows(mesh, dim)
            spans = [(row0, rows, d) for (row0, rows), d
                     in zip(blocks_of(mesh, dim), mesh.devices)]
        blocks = []
        for row0, rows, bdev in spans:
            # the block's rows are worked on its own device: the
            # Hamiltonian's replica there and a copy of the search keys
            h = self.h.on(bdev)
            bindex = index.on(bdev)
            diag = torch.zeros(rows, dtype=torch.float32, device=bdev)
            elems = torch.zeros((C, rows), dtype=torch.float32, device=bdev)
            tgt = torch.zeros((C, rows), dtype=torch.int32, device=bdev)
            for start in range(row0, min(dim, row0 + rows), chunk):
                part = to_device(states[start:min(dim, row0 + rows,
                                                  start + chunk)], bdev)
                a, b = start - row0, start - row0 + part.shape[0]
                conn, el = h.connections_device(part)   # (M, C, W), (M, C)
                row, hit = bindex.find(h.keys_device(conn))
                del conn
                tgt[:, a:b] = torch.where(hit, row, 0).T
                elems[:, a:b] = torch.where(hit, el, 0.0).T
                diag[a:b] = h.diagonal_device(part)
            blocks.append((row0, diag, elems, tgt))
        if mesh is None:
            return blocks[0][1:]
        from ..parallel.sharded_matvec import ShardedEll
        return ShardedEll(mesh, blocks, dim, C, pad)

    def _ell_structure(self):
        """ELL (diag, elems_t, target_idx_t) on the device, tables in the
        (C, N) layout of ``ops/ell_spmv.py``: from the full-space
        connection table for an unrestricted molecule, else built on the
        device for the subspace's states (:meth:`_build_ell_device`), as
        for 4-word determinants, which have no connection table.  With a
        mesh every subspace takes the device build, which writes each row
        block on its entry's device (``parallel.ShardedEll``).

        The JAX package also kept a host build for Hamiltonians without
        device connections or without a 32-bit key; here every Hamiltonian
        has ``connections_device`` and an int64 key (a pair at four
        words), so that route has no counterpart."""
        if self._ell is None:
            if not self._ell_fits_memory():
                raise EvolutionBudgetError(
                    f"ELL table of {self.dim} x {self.h.n_connections} "
                    f"entries exceeds the memory budget")
            t = None
            if (self.is_molecular and not self.restricted
                    and self.mesh is None):
                from ..utils.connection_table import build_connection_table
                t = build_connection_table(
                    self.h, max_entries=self.dim * self.h.n_connections)
            if t is not None:
                self._ell = (t.diag, t.elems.T.contiguous(),
                             t.target_idx.T.contiguous())
            else:
                self._ell = self._build_ell_device(self.subspace,
                                                   mesh=self.mesh)
        return self._ell

    def _ell_matvec(self):
        """The ELL product as a closure over (B, N) stacks: the kernel on
        the tables, or the mesh's row-block products."""
        ell = self._ell_structure()
        if self.mesh is not None:
            return ell.matvec
        return lambda v: ell_spmv(*ell, v)

    def _evolve_device_ell(self, psi: np.ndarray) -> np.ndarray:
        """ELL Lanczos propagator; the span ``skqd.evolve`` (synchronized),
        the first one holding the table build."""
        with span("skqd.evolve", sync=True):
            mv = self._ell_matvec()
            re, im = self._psi_to_device(psi)
            out_r, out_i = _lanczos_expm_impl(
                mv, re, im, self.config.time_step,
                min(self.config.lanczos_dim, self.dim))
            return out_r.cpu().numpy() + 1j * out_i.cpu().numpy()

    def evolve(self, psi: np.ndarray) -> np.ndarray:
        """exp(-i dt H) psi for a host complex vector over the subspace.

        ``auto`` picks a device propagator (dense, then ELL) and raises
        :class:`EvolutionBudgetError` when neither fits the device's
        memory; the host propagator runs only when asked for by name or
        with ``use_device_evolution=False``.
        Trotter mode has no subspace vector: it evolves the device
        statevector through :meth:`_evolve_trotter`."""
        if self.use_trotter:
            raise RuntimeError("Trotter mode evolves the statevector "
                               "through _evolve_trotter")
        mode = self.config.evolution
        if not self.config.use_device_evolution or self.dim <= 1:
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
        """Measurement counts {subspace_index: count}, in the span
        ``skqd.sample``."""
        with span("skqd.sample"):
            re, im = self._psi_to_device(psi)
            counts = _sample_counts_device(re, im, shots,
                                           self.generator).cpu().numpy()
            nz = np.nonzero(counts)[0]
            return {int(i): int(counts[i]) for i in nz}

    def generate_krylov_samples(self) -> List[Dict[int, int]]:
        """Sample at every Krylov step k=0..K-1, evolving in between."""
        c = self.config
        if self.use_trotter:
            return self._generate_krylov_samples_trotter()
        psi = np.zeros(self.dim, dtype=np.complex128)
        psi[self._index_of(self.initial_state)[0]] = 1.0
        samples = []
        for k in range(c.max_krylov_dim):
            samples.append(self.sample_state(psi, c.shots_per_krylov))
            if k < c.max_krylov_dim - 1:
                psi = self.evolve(psi)
                psi = psi / np.linalg.norm(psi)
        return samples

    def _generate_krylov_samples_trotter(self) -> List[Dict[int, int]]:
        """Statevector path: psi stays a device (re, im) float32 pair of
        2^n amplitudes for the whole Krylov sweep; sampling is cumsum +
        searchsorted of uniforms from the instance's generator, and the
        sampled indices are the configurations themselves."""
        c = self.config
        start = int(np.atleast_2d(self.initial_state)[0, 0])
        re = torch.zeros(self.dim, dtype=torch.float32, device=self.device)
        re[start] = 1.0
        im = torch.zeros_like(re)
        sharded = self._sharded_statevector()
        if sharded:
            from ..parallel.sharded_trotter import (gather_statevector,
                                                    shard_statevector)
            re, im = shard_statevector(self.mesh, re, im)
        samples = []
        for k in range(c.max_krylov_dim):
            with span("skqd.sample"):
                u = torch.rand(c.shots_per_krylov, generator=self.generator,
                               device=self.device)
                # a sharded state is gathered to the first device to sample
                full_re, full_im = (gather_statevector(self.mesh, re, im)
                                    if sharded else (re, im))
                idx = _sample_idx_cdf(full_re ** 2 + full_im ** 2, u)
                del full_re, full_im
                vals, counts = torch.unique(idx, return_counts=True)
                samples.append(dict(zip(vals.tolist(), counts.tolist())))
            if k < c.max_krylov_dim - 1:
                re, im = self._evolve_trotter(re, im)
        return samples

    def build_cumulative_basis(self, samples: List[Dict[int, int]]
                               ) -> List[np.ndarray]:
        """Running union of sampled configs per Krylov dimension."""
        seen: Dict[int, int] = {}
        bases = []
        with span("skqd.basis"):
            for counts in samples:
                for idx, ct in counts.items():
                    seen[idx] = seen.get(idx, 0) + ct
                idxs = np.sort(np.fromiter(seen.keys(), dtype=np.int64))
                if self.subspace is None:
                    # Trotter mode: sampled indices are the packed configs
                    bases.append(idxs.astype(np.uint32)[:, None])
                else:
                    bases.append(self.subspace[idxs])
        return bases

    # ------------------------------------------------------------------
    # Projected eigensolve with stability guardrails
    # ------------------------------------------------------------------

    # sampled spin bases above this many states seed the host eigsh with
    # a device ELL Lanczos vector
    SEEDED_EIGSH_MIN_ROWS = 200_000

    def compute_ground_state_energy(self, basis: np.ndarray,
                                    return_vector: bool = False):
        """Project H on ``basis`` (``Hamiltonian.projected``: symmetrized,
        dense or sparse by size), regularize, and diagonalize (host f64;
        ``lowest_pairs``): a dense H past condition 1e12 takes the SVD
        fallback, a sparse one whose ``eigsh`` does not converge a dense
        solve.  With ``return_vector`` returns (energy, ground vector).

        For sampled spin bases above ``SEEDED_EIGSH_MIN_ROWS`` states a
        float32 device ELL Lanczos (through the ELL kernel on a card)
        gets the ground vector to ~1e-4, and ``eigsh`` starts from it."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        nb = len(basis)
        reg = self.config.regularization

        v0 = None
        if nb > self.SEEDED_EIGSH_MIN_ROWS and not self.is_molecular:
            from ..postprocessing.eigensolver import lanczos_ground_state_ell
            from ..utils.memory import MemoryBudget
            ell = self._build_ell_device(basis)
            m_fit = MemoryBudget.for_device(self.device).lanczos_ell_m(
                nb, self.h.n_connections, m_max=80)
            _, v = lanczos_ground_state_ell(*ell, m=min(m_fit, nb))
            v0 = v.double().cpu().numpy()
            del ell, v
        with span("skqd.project"):
            H = self.h.projected(basis)
        if sp.issparse(H):
            H = H + reg * sp.eye(nb)
            # one pair, the one read: a second would have ARPACK converge
            # an unread Ritz pair, often inside a degenerate band
            try:
                vals, vecs = lowest_pairs(H, v0=v0)
            except spla.ArpackNoConvergence:
                vals, vecs = lowest_pairs(H.toarray())
        else:
            H = H + reg * np.eye(nb)
            cond = np.linalg.cond(H) if nb > 1 else 1.0
            if not np.isfinite(cond) or cond > 1e12:
                # SVD fallback with singular-value clamping
                u, s, vt = np.linalg.svd(H)
                s = np.maximum(s, 1e-10)
                H = u @ np.diag(s) @ vt
                H = 0.5 * (H + H.T)
            vals, vecs = lowest_pairs(H)
        e = float(vals[0] - reg)
        if return_vector:
            return e, vecs[:, 0]
        return e

    # ------------------------------------------------------------------
    # The oracle of an enumerated subspace
    # ------------------------------------------------------------------

    def _oracle_cache_path(self):
        """Disk-cache location of the subspace-oracle energy, keyed by the
        Hamiltonian content and the subspace size (the JAX package's hash
        and ``FGK_INTEGRAL_CACHE`` override).  The host refine of a
        million-state sector takes many minutes; the oracle is
        instrumentation, so the cache only saves repeated runs.  The
        ``torch_`` prefix keeps the port's oracle apart from the JAX
        package's file of the same hash in the same directory."""
        import hashlib
        import os
        from pathlib import Path
        h = self.h
        hsh = hashlib.sha1()
        hsh.update(type(h).__name__.encode())
        for attr in ("n_sites", "Jx", "Jy", "Jz", "V", "h", "L", "periodic"):
            hsh.update(repr(getattr(h, attr, None)).encode())
        for attr in ("h_x", "h_y", "h_z"):
            v = getattr(h, attr, None)
            if v is not None:
                hsh.update(np.asarray(v, np.float64).tobytes())
        hsh.update(bytes(memoryview(np.int64([self.dim]))))
        root = Path(os.environ.get(
            "FGK_INTEGRAL_CACHE",
            Path.home() / ".cache" / "fgk_tpu_integrals"))
        return root / f"torch_sector_{hsh.hexdigest()}.txt"

    def exact_subspace_energy(self, m: int = 120, refine_host: bool = True,
                              tol: float = 1e-9) -> float:
        """Exact ground-state energy of the whole enumerated subspace.

        A float32 device ELL Lanczos with full reorthogonalization (the
        ELL kernel at B = 1 on a card) finds the subspace ground state;
        a host f64 ``eigsh`` seeded with that vector then refines it to
        oracle grade.  For molecules this equals ``fci_energy``; its use
        is the spin sectors (Heisenberg-24: 2,704,156 states), which have
        no other oracle.  ``refine_host=False`` returns the device energy.
        A device failure raises: the host refine never runs unseeded.
        """
        if self.subspace is None:
            raise RuntimeError(
                "Trotter mode has no enumerated subspace; the exact energy "
                "of the full 2^n space is out of reach by construction")
        path = self._oracle_cache_path()
        if refine_host:
            try:
                return float(path.read_text())
            except (OSError, ValueError):
                pass
        from ..postprocessing.eigensolver import lanczos_ground_state_mv
        from ..utils.memory import MemoryBudget
        mv = self._ell_matvec()
        m_fit = MemoryBudget.for_device(self.device).lanczos_ell_m(
            self.dim, self.h.n_connections, m_max=m)
        # a block capped by memory recovers its depth through restarts
        n_restart = max(1, -(-m // m_fit))
        # with a mesh the vectors keep the subspace's length: the padding
        # rows never reach them
        e_dev, v = lanczos_ground_state_mv(
            mv, self.dim, self.device, m=min(m_fit, self.dim),
            restarts=n_restart)
        if not refine_host:
            return e_dev
        H = self.subspace_hamiltonian
        H = (H + H.T) * 0.5
        vals, _ = lowest_pairs(H, v0=v.double().cpu().numpy(), tol=tol)
        e = float(vals[0])
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(repr(e))
        except OSError:
            pass
        return e

    def run(self, final_only: bool = False) -> Dict:
        """Energies against Krylov dimension on the cumulative bases.
        ``final_only`` skips the intermediate eigensolves (NaN in their
        place)."""
        with span("skqd.run"):
            samples = self.generate_krylov_samples()
            bases = self.build_cumulative_basis(samples)
            if final_only:
                energies = [np.nan] * (len(bases) - 1) + [
                    self.compute_ground_state_energy(bases[-1])]
            else:
                energies = [self.compute_ground_state_energy(b)
                            for b in bases]
        return {
            "energies": energies,
            "basis_sizes": [len(b) for b in bases],
            "bases": bases,
            "samples": samples,
            "final_energy": energies[-1] if energies else np.nan,
        }


class FlowGuidedSKQD(SampleBasedKrylovDiagonalization):
    """SKQD combined with a given (flow- or Selected-CI-found) basis."""

    def __init__(self, hamiltonian: Hamiltonian, nf_basis: np.ndarray,
                 config: Optional[SKQDConfig] = None,
                 initial_state: Optional[np.ndarray] = None,
                 mesh=None, subspace_states: Optional[np.ndarray] = None):
        super().__init__(hamiltonian, config, initial_state, mesh=mesh,
                         subspace_states=subspace_states)
        self.nf_basis = np.atleast_2d(np.asarray(nf_basis, np.uint32))

    def get_combined_basis(self, krylov_basis: np.ndarray) -> np.ndarray:
        """unique(NF union Krylov), first occurrence order."""
        both = np.concatenate([self.nf_basis, krylov_basis], axis=0)
        _, idx = np.unique(self.h.keys(both), return_index=True)
        return both[np.sort(idx)]

    # above this NF-basis size only the final cumulative union is
    # diagonalized (each per-k solve is a fresh CSR build + ARPACK)
    FINAL_ONLY_NF_ROWS = 100_000

    def run_with_nf(self, final_only: Optional[bool] = None) -> Dict:
        """Per-k Krylov-only vs combined energies with variational
        monotonicity checks and best-stable tracking.  ``final_only``
        (by default above ``FINAL_ONLY_NF_ROWS`` NF rows) skips the
        per-k eigensolves before the last."""
        c = self.config
        if final_only is None:
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
