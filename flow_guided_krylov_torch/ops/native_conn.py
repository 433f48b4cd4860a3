"""ctypes binding for the native connection-hits kernel
(``native/conn_hits.cpp``, shared with the JAX package).

Counterpart of ``flow_guided_krylov_tpu/ops/native_conn.py``.  The kernel
fuses enumeration, sorted-key membership and Slater-Condon values for the
connections that land in a basis; the projected-H builds use it whenever
the library is available, and the NumPy mirror otherwise (the JAX
package's own route, so both packages build the same matrices).

Differences from the JAX loader: the library is built into the port's
build directory by :func:`..utils.build.build_library` (temporary name,
then ``os.rename``), a failed compile raises instead of passing silently,
and an overflowing call is retried chunk by chunk instead of allocating
the whole result at once.  A call is cut into row spans, one a core (at
most 16), that run at once (ctypes releases the GIL for the native
call); the spans' results are concatenated in row order, so the arrays
equal one sequential call's.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from ..utils.build import build_library

__all__ = ["conn_hits_native", "native_available"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "conn_hits.cpp")

# source rows per native call; the result buffer starts at 256 hits a row
_ROWS_PER_CALL = 1 << 16
# worker threads of a call: one a core, at most this many
_MAX_THREADS = 16


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The built library, or None where the host has no C++ compiler."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(_SRC):
        return None
    lib = build_library("fgk_conn_hits", [_SRC],
                        [gxx, "-std=c++17", "-O3", "-march=native",
                         "-shared", "-fPIC"])
    u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.fgk_conn_hits.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, u64, u64,
        ctypes.c_int64, u64, u64,
        f64, f64, f64, f64,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        f64,
    ]
    lib.fgk_conn_hits.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    """Whether the host hit search runs natively (a failed build
    raises)."""
    return _load() is not None


def conn_hits_native(h, new: np.ndarray, sorted_keys: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Connections of ``new`` dets that land in a SORTED key array.

    ``h`` is a molecular Hamiltonian exposing ``tables``; ``sorted_keys``
    is ``np.sort(h.keys(basis))``: uint64 at W = 2, ``KEY128`` records at
    W = 4, where the kernel takes 64-bit channels and compares the
    (alpha, beta) key pair (``wide_keys``).  Returns (rows,
    sorted_positions, values) with values float64, or None when ``h`` has
    no Slater tables or no compiler is available.
    """
    t = getattr(h, "tables", None)
    if t is None:
        return None
    lib = _load()
    if lib is None:
        return None
    new = np.atleast_2d(np.asarray(new, np.uint32))
    wide = h.pack_words == 4
    if wide:      # [a_hi, a_lo, b_hi, b_lo] -> 64-bit channels
        a = np.ascontiguousarray(new[:, 1].astype(np.uint64)
                                 | (new[:, 0].astype(np.uint64) << 32))
        b = np.ascontiguousarray(new[:, 3].astype(np.uint64)
                                 | (new[:, 2].astype(np.uint64) << 32))
        kk = np.ascontiguousarray(sorted_keys).view(np.uint64).reshape(-1, 2)
        key_a = np.ascontiguousarray(kk[:, 0])
        key_b = np.ascontiguousarray(kk[:, 1])
    else:
        a = np.ascontiguousarray(new[:, 0].astype(np.uint64))
        b = np.ascontiguousarray(new[:, 1].astype(np.uint64))
        key_a = np.ascontiguousarray(sorted_keys, np.uint64)
        key_b = np.zeros(len(key_a), np.uint64)
    ints = [np.ascontiguousarray(x) for x in (t.h1, t.jj, t.ex, t.h2)]

    def call(start: int, stop: int):
        ca, cb = a[start:stop], b[start:stop]
        cap = max(1024, 256 * len(ca))
        while True:
            rows = np.empty(cap, np.int32)
            pos = np.empty(cap, np.int64)
            vals = np.empty(cap, np.float64)
            total = lib.fgk_conn_hits(
                t.n_orb, t.n_alpha, t.n_beta, int(wide), len(ca), ca, cb,
                len(key_a), key_a, key_b, *ints, cap, rows, pos, vals)
            if total <= cap:
                break
            cap = int(total)     # this chunk's exact count
        return rows[:total] + np.int32(start), pos[:total], vals[:total]

    n = len(a)
    threads = min(os.cpu_count() or 1, _MAX_THREADS)
    step = max(1, min(_ROWS_PER_CALL, -(-n // threads)))
    spans = [(s, min(n, s + step)) for s in range(0, n, step)]
    with ThreadPoolExecutor(max(1, min(threads, len(spans)))) as pool:
        parts = list(pool.map(lambda sp: call(*sp), spans))
    if not parts:
        return (np.empty(0, np.int32), np.empty(0, np.int64),
                np.empty(0, np.float64))
    return tuple(np.concatenate(p) for p in zip(*parts))
