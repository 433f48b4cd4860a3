"""Build a shared library from sources in the repository, once per content.

The output lands in ``flow_guided_krylov_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and the command, so an
edited source is rebuilt and an unchanged one is reused.  The compiler
writes to a temporary name and the result is moved into place with
``os.rename``: two processes building at once each finish their own file
and neither can load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Sequence

__all__ = ["BUILD_DIR", "build_library", "find_nvcc"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix.  Raises when none exists."""
    cands: List[str] = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str, sources: Sequence[str],
                  command: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` with ``command + [-o OUT] + sources`` unless a
    library of the same content exists, then load it.

    Raises ``RuntimeError`` with the compiler's output when the build
    fails.  The compiler's messages of a successful build are kept beside
    the library as ``<name>-<hash>.log``.
    """
    h = hashlib.sha256()
    for part in command:
        h.update(part.encode() + b"\0")
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    stem = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}")
    out = stem + ".so"
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{stem}.{os.getpid()}.tmp.so"
        proc = subprocess.run([*command, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        with open(f"{stem}.{os.getpid()}.tmp.log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.rename(f"{stem}.{os.getpid()}.tmp.log", stem + ".log")
        os.rename(tmp, out)
    return ctypes.CDLL(out)
