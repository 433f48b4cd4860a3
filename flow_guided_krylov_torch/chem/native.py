"""ctypes binding for the native C++ ERI engine (``native/integrals.cpp``,
shared with the JAX package).

Builds ``libfgk_integrals`` at first use with g++ through
:func:`..utils.build.build_library` into the port's ``_build/`` directory
(temporary name, then ``os.rename``), with the compiler flags the JAX
package uses, and exposes :func:`eri_tensor_native`.  Returns None when
the host has no g++ or the build fails, so the pure-NumPy engine in
``integrals.py`` takes over; :func:`native_available` says which engine
runs.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from typing import List, Optional

import numpy as np

from ..utils.build import build_library

__all__ = ["eri_tensor_native", "native_available"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "integrals.cpp")


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(_SRC):
        return None
    try:
        lib = build_library("fgk_integrals", [_SRC],
                            [gxx, "-std=c++17", "-O3", "-march=native",
                             "-fopenmp", "-shared", "-fPIC"])
    except (RuntimeError, OSError):
        return None
    lib.fgk_eri_tensor.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.fgk_eri_tensor.restype = None
    return lib


def native_available() -> bool:
    return _load() is not None


def eri_tensor_native(funcs: List) -> Optional[np.ndarray]:
    """Compute the chemist-notation ERI tensor natively; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(funcs)
    if any(max(f.lmn) > 2 for f in funcs):
        return None  # beyond the engine's per-direction LMAX; Python fallback
    lmn = np.array([f.lmn for f in funcs], np.int32)
    centers = np.ascontiguousarray(
        np.array([f.center for f in funcs], np.float64))
    offsets = np.zeros(n + 1, np.int32)
    exps: List[float] = []
    coefs: List[float] = []
    for i, f in enumerate(funcs):
        exps.extend(f.exps.tolist())
        coefs.extend(f.coefs.tolist())
        offsets[i + 1] = len(exps)
    eri = np.zeros(n ** 4, np.float64)
    lib.fgk_eri_tensor(n, np.ascontiguousarray(lmn),
                       centers, offsets,
                       np.ascontiguousarray(np.asarray(exps, np.float64)),
                       np.ascontiguousarray(np.asarray(coefs, np.float64)),
                       eri)
    return eri.reshape(n, n, n, n)
