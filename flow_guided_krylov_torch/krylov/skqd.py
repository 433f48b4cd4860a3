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
  and magnetization-conserving ones whose sector is small, evolve in an
  enumerated subspace with the dense or scipy propagator.

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

from dataclasses import dataclass
from math import comb
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..hamiltonians.base import Hamiltonian
from ..hamiltonians.spin import extract_coeffs_and_paulis
from ..ops.bits import _parity32
from ..ops.ell_spmv import ell_spmv
from ..ops.x_sweep import TILE_BITS, _pauli_masks, make_gathered_sweeps

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
    num_trotter_steps: int = 8          # Trotter substeps per evolve
    shots_per_krylov: int = 100_000
    num_eigenvalues: int = 2
    regularization: float = 1e-8
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
    library's float32 ``cos`` enters it."""
    idx = torch.arange(1 << n, dtype=torch.int64, device=device)
    D = torch.zeros(1 << n, dtype=torch.float32, device=device)
    for c, zm in diag:
        sign = 1.0 - 2.0 * _parity32(idx & zm).to(torch.float32)
        D = D + float(np.float32(c)) * sign
    ang, where = torch.unique(0.5 * dt_sub * D, return_inverse=True)
    ang = ang.double().cpu().numpy()
    cos = torch.as_tensor(np.cos(ang).astype(np.float32), device=device)
    sin = torch.as_tensor(np.sin(ang).astype(np.float32), device=device)
    return cos[where], -sin[where]


def _diag_mul(re: torch.Tensor, im: torch.Tensor, hr: torch.Tensor,
              hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re + i im) * (hr + i hi), elementwise."""
    return re * hr - im * hi, re * hi + im * hr


# ---------------------------------------------------------------------------
# SKQD
# ---------------------------------------------------------------------------

class SampleBasedKrylovDiagonalization:
    """Classical SKQD: in the particle-conserving subspace for molecules;
    in the magnetization sector, the full space, or (past
    ``trotter_threshold`` sites) a Trotterized statevector for spins."""

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[SKQDConfig] = None,
                 initial_state: Optional[np.ndarray] = None):
        self.h = hamiltonian
        self.config = config or SKQDConfig()
        self.device = hamiltonian.device
        self.is_molecular = hasattr(hamiltonian, "n_alpha")
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

        if self.use_trotter:
            self.subspace = None
            self.dim = 1 << n_sites
            self._keys = self._order = self._sorted_keys = None
        else:
            if self.is_molecular:
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
    # Statevector Trotter propagator (large spin systems)
    # ------------------------------------------------------------------

    def _trotter_ops(self):
        """One second-order Trotter substep over the Hamiltonian's Pauli
        words, built once: diag . sweep(seq) . sweep(reversed(seq)) . diag.

        * diag: every diagonal word (x_mask == 0) folds into one
          half-phase exp(-i dt/2 * D), a (cos, -sin) float32 pair.
        * seq: the off-diagonal words at half angle, first those whose
          x_mask lies inside the contiguous tile, 0 < x_mask <
          2^min(TILE_BITS, n) (low), then the others (high).  seq then
          reversed(seq) is one list that ``plan_sweeps`` cuts, without
          reordering, into gathered-tile sweeps: three launches at TFIM-24
          (the 14 low words on bits 0..13, the 20 high ones on bits
          {0..3, 14..23}, the low words reversed).  On the CPU the list is
          the same chain of ``_pauli_rotation_pair`` calls.

        A forward-then-reversed sweep is second order for any order of
        the words.  When every word is low, this is the JAX package's
        fused substep; otherwise it is its ``FGK_PALLAS_SWEEP`` order.
        """
        if self._trotter is not None:
            return self._trotter
        coeffs, words = extract_coeffs_and_paulis(self.h)
        n = self.h.n_sites
        masks = [_pauli_masks(w) for w in words]
        dt_sub = self.config.time_step / max(self.config.num_trotter_steps, 1)
        diag = [(c, zm) for c, (xm, zm, _) in zip(coeffs, masks) if xm == 0]
        offd = [(c * dt_sub / 2, xm, zm, ny)
                for c, (xm, zm, ny) in zip(coeffs, masks) if xm != 0]
        tile = 1 << min(TILE_BITS, n)
        seq = ([w for w in offd if w[1] < tile]
               + [w for w in offd if w[1] >= tile])
        sweeps = make_gathered_sweeps(n, seq + seq[::-1])
        hp_re, hp_im = _half_phase(diag, n, dt_sub, self.device)

        def substep(re, im):
            re, im = _diag_mul(re, im, hp_re, hp_im)
            re, im = sweeps(re, im)
            return _diag_mul(re, im, hp_re, hp_im)

        self._trotter = substep
        return substep

    def _evolve_trotter(self, re: torch.Tensor, im: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """exp(-i dt H) on a device (re, im) statevector pair, in
        ``num_trotter_steps`` substeps."""
        substep = self._trotter_ops()
        for _ in range(max(self.config.num_trotter_steps, 1)):
            re, im = substep(re, im)
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
        memory; the host propagator runs only when asked for by name.
        Trotter mode has no subspace vector: it evolves the device
        statevector through :meth:`_evolve_trotter`."""
        if self.use_trotter:
            raise RuntimeError("Trotter mode evolves the statevector "
                               "through _evolve_trotter")
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
            if not self.is_molecular:
                raise NotImplementedError(
                    "ELL evolution of a spin subspace needs the device "
                    "table build (_build_ell_device), which comes with the "
                    "restricted-SKQD slice (ROADMAP Queue 1 item 3); use "
                    "evolution='dense' or 'scipy'")
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
        samples = []
        for k in range(c.max_krylov_dim):
            u = torch.rand(c.shots_per_krylov, generator=self.generator,
                           device=self.device)
            idx = _sample_idx_cdf(re ** 2 + im ** 2, u)
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

    def compute_ground_state_energy(self, basis: np.ndarray) -> float:
        """Project H on ``basis`` and diagonalize (host f64): Hermitize,
        regularize, condition check -> SVD fallback, dense/sparse routing.

        The JAX package seeds ``eigsh`` for sampled spin bases above 200k
        states with a device ELL Lanczos vector; that seed comes with the
        device eigensolvers (ROADMAP Queue 1 item 5).  The unseeded solve
        reaches the same energy."""
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

    def run(self, final_only: bool = False) -> Dict:
        """Energies against Krylov dimension on the cumulative bases.
        ``final_only`` skips the intermediate eigensolves (NaN in their
        place)."""
        samples = self.generate_krylov_samples()
        bases = self.build_cumulative_basis(samples)
        if final_only:
            energies = [np.nan] * (len(bases) - 1) + [
                self.compute_ground_state_energy(bases[-1])]
        else:
            energies = [self.compute_ground_state_energy(b) for b in bases]
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
