"""Plain reference of the first stage-1 step's NQS half: the variational
energy the step reports and the NQS gradient the optimizer is handed.

PyTorch alone, float64 by default.  The NQS is an MLP of ``relu`` hidden
layers, a linear output o and log|psi| = s * tanh(o), fed the (2n,)
occupations of a determinant (alpha orbitals, then beta, orbital order).
Given the parameters before the step, the step's sampled configurations
and the molecule's Hamiltonian over every determinant:

* E_loc(x) = sum_y H_xy psi(y) / psi(x), psi over the whole space;
* p(x) = softmax(2 log|psi(x)|) over the batch's distinct configurations;
* E = sum_x p(x) E_loc(x), the step's reported energy;
* the gradient of sum_x (E_loc(x) - E) * 2 log|psi(x)| * p(x), with E_loc,
  E and p held fixed, scaled as a global-norm clip at ``max_norm`` does.

``tf32=True`` is the benchmark's control: every matrix product's inputs
rounded to TF32 (10 mantissa bits) and computed in float32, on any device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["occupations", "first_step"]


def occupations(dets: np.ndarray, n: int) -> np.ndarray:
    """(N, 2n) 0/1 occupations of (N, 2) (alpha, beta) words."""
    dets = np.asarray(dets, np.int64)
    bits = np.arange(n)
    return np.concatenate([(dets[:, 0:1] >> bits) & 1,
                           (dets[:, 1:2] >> bits) & 1], 1).astype(np.float64)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def _rounded(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, with the gradient passing straight through."""
    x0 = x.detach()
    return x + (_tf32(x0) - x0)


def _linear(x, w, b, tf32):
    if tf32:
        return _rounded(x) @ _rounded(w).T + b
    return x @ w.T + b


def log_amplitudes(params: Sequence[Tuple[str, torch.Tensor]],
                   x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """log|psi| of the rows of x; ``params`` named as the module names
    them: ``dense.<i>.weight``, ``dense.<i>.bias`` and the scale
    ``log_amp_scale``."""
    named = dict(params)
    depth = len([k for k in named if k.endswith(".weight")])
    layers = [(named[f"dense.{i}.weight"], named[f"dense.{i}.bias"])
              for i in range(depth)]
    h = x
    for w, b in layers[:-1]:
        h = torch.relu(_linear(h, w, b, tf32))
    w, b = layers[-1]
    return named["log_amp_scale"] * torch.tanh(
        _linear(h, w, b, tf32).squeeze(-1))


def first_step(params: Dict[str, np.ndarray], configs: np.ndarray,
               dets: np.ndarray, H: sp.csr_matrix, n: int,
               max_norm: float, device="cpu", tf32: bool = False
               ) -> Tuple[float, Dict[str, float]]:
    """(E, {leaf: norm of its clipped gradient}) of the step on
    ``configs`` ((B, 2n) 0/1) with NQS parameters ``params`` (name ->
    array, named as the module names them), ``H`` over every determinant
    ``dets`` in their rows' order."""
    dtype = torch.float32 if tf32 else torch.float64
    leaves = [(k, torch.tensor(np.asarray(v), dtype=dtype, device=device,
                               requires_grad=True))
              for k, v in params.items()]
    dets = np.asarray(dets, np.int64)
    key = (dets[:, 0] << 32) | dets[:, 1]
    order = np.argsort(key)
    c = np.asarray(configs).astype(np.int64)
    w = 1 << np.arange(n)
    ck = ((c[:, :n] * w).sum(1) << 32) | (c[:, n:] * w).sum(1)
    pos = np.searchsorted(key[order], ck)
    if np.any(pos >= len(key)) or np.any(key[order][np.minimum(
            pos, len(key) - 1)] != ck):
        raise ValueError("a sampled configuration is not a determinant "
                         "of the space")
    rows = np.unique(order[pos])

    occ_all = torch.tensor(occupations(dets, n), dtype=dtype, device=device)
    with torch.no_grad():
        la_all = log_amplitudes(leaves, occ_all, tf32)
        psi = torch.exp(la_all - la_all.max()).cpu().numpy()
    if tf32:
        Hm = sp.csr_matrix(H, dtype=np.float32)
        Hm.data = _tf32(torch.from_numpy(Hm.data)).numpy()
        psi = _tf32(torch.from_numpy(psi.astype(np.float32))).numpy()
        hpsi = Hm @ psi
    else:
        hpsi = H @ psi
    e_loc = torch.tensor(hpsi[rows] / psi[rows], dtype=dtype, device=device)

    la = log_amplitudes(leaves, occ_all[torch.as_tensor(rows,
                                                        device=device)],
                        tf32)
    with torch.no_grad():
        p = torch.softmax(2.0 * la, 0)
        energy = (e_loc * p).sum()
    loss = ((e_loc - energy) * (2.0 * la) * p).sum()
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    total = torch.linalg.vector_norm(norms)
    scale = 1.0 if float(total) < max_norm else max_norm / float(total)
    return float(energy), {k: float(nm) * scale
                           for (k, _), nm in zip(leaves, norms)}
