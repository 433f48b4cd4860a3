"""Measurement/basis bookkeeping utilities.

A copy of the JAX package's ``postprocessing/utils.py`` (host NumPy):
bitstring codecs, cumulative measurement merging, probability filtering,
basis overlap and sparsity metrics over packed uint configurations.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = [
    "bitstring_to_int", "int_to_bitstring", "merge_measurements",
    "filter_by_probability", "basis_overlap", "ground_state_sparsity",
    "merge_bases",
]


def bitstring_to_int(bitstring: str) -> int:
    """'0101' (qubit 0 leftmost) -> integer with qubit i at bit i."""
    return sum(1 << i for i, b in enumerate(bitstring) if b == "1")


def int_to_bitstring(state: int, n_qubits: int) -> str:
    return "".join("1" if (state >> i) & 1 else "0" for i in range(n_qubits))


def merge_measurements(counts_list: Sequence[Dict[int, int]]
                       ) -> Dict[int, int]:
    """Union of measurement count dicts."""
    merged: Dict[int, int] = {}
    for counts in counts_list:
        for state, ct in counts.items():
            merged[state] = merged.get(state, 0) + ct
    return merged


def filter_by_probability(counts: Dict[int, int],
                          min_probability: float = 0.0,
                          max_states: int | None = None) -> Dict[int, int]:
    """Drop rare outcomes / keep top-k."""
    total = sum(counts.values())
    if total == 0:
        return {}
    items = [(s, c) for s, c in counts.items()
             if c / total >= min_probability]
    items.sort(key=lambda sc: -sc[1])
    if max_states is not None:
        items = items[:max_states]
    return dict(items)


def basis_overlap(basis_a: np.ndarray, basis_b: np.ndarray,
                  keys_fn=None) -> Dict[str, int]:
    """Set algebra between two packed bases."""
    def default_keys(p):
        p = np.atleast_2d(np.asarray(p, np.uint64))
        if p.shape[1] == 1:
            return p[:, 0]
        return (p[:, 0] << np.uint64(32)) | p[:, 1]
    kf = keys_fn or default_keys
    ka = np.unique(kf(basis_a))
    kb = np.unique(kf(basis_b))
    inter = np.intersect1d(ka, kb, assume_unique=True)
    return {
        "n_a": int(len(ka)), "n_b": int(len(kb)),
        "n_common": int(len(inter)),
        "n_a_only": int(len(ka) - len(inter)),
        "n_b_only": int(len(kb) - len(inter)),
    }


def ground_state_sparsity(coefficients: np.ndarray,
                          thresholds: Sequence[float] = (1e-2, 1e-3, 1e-4),
                          ) -> Dict[str, float]:
    """Support-size metrics of a normalized CI vector."""
    c = np.abs(np.asarray(coefficients, float))
    c = c / np.linalg.norm(c)
    out: Dict[str, float] = {"n_total": int(len(c))}
    for t in thresholds:
        out[f"n_above_{t:g}"] = int((c > t).sum())
    p = c ** 2
    p = p[p > 1e-300]
    out["entropy"] = float(-(p * np.log(p)).sum())
    out["participation_ratio"] = float(1.0 / np.sum(c ** 4))
    return out


def merge_bases(*bases: np.ndarray) -> np.ndarray:
    """Deduplicating union of packed bases."""
    stacked = np.concatenate([np.atleast_2d(b) for b in bases], axis=0)
    if stacked.shape[1] == 1:
        keys = stacked[:, 0].astype(np.uint64)
    else:
        keys = (stacked[:, 0].astype(np.uint64) << np.uint64(32)) \
            | stacked[:, 1].astype(np.uint64)
    _, idx = np.unique(keys, return_index=True)
    return stacked[np.sort(idx)]
