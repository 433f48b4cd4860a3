"""Plain reference for the periodic transverse-field Ising chain

    H = -V sum_i Z_i Z_{i+1} - h sum_i X_i,   site n == site 0,

on n sites; a configuration is an integer whose bit i is site i (bit 0 is
Z = +1).  NumPy, SciPy and plain PyTorch operations only.

* :func:`free_fermion_energy`: the exact ground energy (Jordan-Wigner,
  even-parity sector, exact for the finite chain);
* :func:`projected_hamiltonian`: H on a set of configurations, float64 CSR;
* :func:`krylov_states`: exp(-i dt H)^k |0...0> for k = 1..K by the
  second-order Trotter product e^{-i t D/2} e^{-i t X} e^{-i t D/2} in
  ``substeps`` substeps of t = dt / substeps (D the ZZ part, X the field
  part; the field terms commute, so e^{-i t X} is a product of one-site
  rotations).  float64 is the reference; bfloat16 is the benchmark's
  control.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["free_fermion_energy", "projected_hamiltonian", "popcount",
           "krylov_states", "weight_probabilities"]

BLOCK = 4          # sites whose rotations one matrix product applies


def free_fermion_energy(n: int, V: float, h: float) -> float:
    k = (2 * np.arange(n) + 1) * np.pi / n
    return float(-np.sum(np.sqrt(V * V + h * h - 2 * V * h * np.cos(k))))


def _popcount_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64)
    c = np.zeros_like(x)
    while np.any(x):
        c += x & 1
        x = x >> 1
    return c


def _zz(states: np.ndarray, n: int) -> np.ndarray:
    """sum_i z_i z_{i+1} (periodic) of each configuration."""
    mask = (1 << n) - 1
    rot = ((states << 1) | (states >> (n - 1))) & mask
    return n - 2 * _popcount_np(states ^ rot)


def projected_hamiltonian(states: np.ndarray, n: int, V: float,
                          h: float) -> sp.csr_matrix:
    """H on ``states`` (distinct integers), float64 CSR in their order."""
    states = np.asarray(states, np.int64).reshape(-1)
    N = len(states)
    order = np.argsort(states)
    srt = states[order]
    rows, cols, vals = [np.arange(N)], [np.arange(N)], [
        -V * _zz(states, n).astype(np.float64)]
    for i in range(n):
        flipped = states ^ (1 << i)
        pos = np.clip(np.searchsorted(srt, flipped), 0, N - 1)
        hit = srt[pos] == flipped
        rows.append(order[pos[hit]])
        cols.append(np.nonzero(hit)[0])
        vals.append(np.full(int(hit.sum()), -h))
    r, c, v = (np.concatenate(x) for x in (rows, cols, vals))
    return sp.csr_matrix((v, (r, c)), shape=(N, N))


def popcount(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Set bits among the low ``bits`` of each int64 element."""
    c = torch.zeros_like(x)
    for b in range(bits):
        c += (x >> b) & 1
    return c


def _diag_phase(n, V, t, device, dtype):
    """(cos, sin) of -t/2 * D over all 2^n configurations."""
    x = torch.arange(1 << n, dtype=torch.int64, device=device)
    rot = ((x << 1) | (x >> (n - 1))) & ((1 << n) - 1)
    anti = torch.zeros_like(x, dtype=torch.int8)
    y = x ^ rot
    del x, rot
    for b in range(n):
        anti += ((y >> b) & 1).to(torch.int8)
    del y
    zz = (n - 2 * anti.to(torch.float64))
    del anti
    phase = -0.5 * t * (-V * zz)
    del zz
    return torch.cos(phase).to(dtype), torch.sin(phase).to(dtype)


def _field_blocks(h, t, dtype, device):
    """Real and imaginary parts of e^{i h t X}^{(x)BLOCK}."""
    c, s = np.cos(h * t), np.sin(h * t)
    one = np.array([[c, 1j * s], [1j * s, c]])
    m = reduce(np.kron, [one] * BLOCK)
    return (torch.as_tensor(m.real, dtype=dtype, device=device),
            torch.as_tensor(m.imag, dtype=dtype, device=device))


def _apply_field(re, im, n, mr, mi):
    """e^{-i t X} on the state: for each block of BLOCK sites, one
    (2^BLOCK)-wide matrix product over the rows that block indexes."""
    if n % BLOCK:
        raise ValueError(f"n = {n} must be a multiple of {BLOCK}")
    w = 1 << BLOCK
    mrt, mit = mr.T.contiguous(), mi.T.contiguous()
    for lo in range(0, n, BLOCK):
        shape = (1 << (n - lo - BLOCK), w, 1 << lo)

        def rows(x):
            return x.view(shape).transpose(1, 2).reshape(-1, w)

        def back(x):
            return x.view(shape[0], shape[2], w).transpose(1, 2).reshape(-1)

        r, i = rows(re), rows(im)
        re, im = back(r @ mrt - i @ mit), back(i @ mrt + r @ mit)
        del r, i
    return re, im


def krylov_states(n: int, V: float, h: float, dt: float, substeps: int,
                  k_max: int, device, dtype=torch.float64):
    """Yield (k, re, im) for k = 1..k_max: the Trotter-evolved state
    after k steps of dt from |0...0>, each as a real pair of ``dtype``."""
    t = dt / substeps
    cos, sin = _diag_phase(n, V, t, device, dtype)
    mr, mi = _field_blocks(h, t, dtype, device)
    re = torch.zeros(1 << n, dtype=dtype, device=device)
    re[0] = 1.0
    im = torch.zeros_like(re)

    def half(re, im):
        return re * cos - im * sin, re * sin + im * cos

    for k in range(1, k_max + 1):
        for _ in range(substeps):
            re, im = half(re, im)
            re, im = _apply_field(re, im, n, mr, mi)
            re, im = half(re, im)
        yield k, re, im


def weight_probabilities(re: torch.Tensor, im: torch.Tensor,
                         weights: torch.Tensor, n: int) -> np.ndarray:
    """Probability of each Hamming weight 0..n under |psi|^2, float64."""
    p = re.double() ** 2 + im.double() ** 2
    out = torch.zeros(n + 1, dtype=torch.float64, device=p.device)
    out.index_add_(0, weights, p)
    return (out / out.sum()).cpu().numpy()
