"""Host-side quantum-chemistry front end of the port (integrals + RHF).

The port's own copy of the JAX package's ``chem`` modules that it uses:
``basis.py``, ``integrals.py``, ``scf.py`` and ``native.py`` (the ctypes
binding of the shared ``native/integrals.cpp``).  Float64 NumPy on the
host; the integral cache keeps the JAX package's file format and its
``FGK_INTEGRAL_CACHE`` override.
"""

from .basis import build_shells, nuclear_repulsion
from .scf import MolecularIntegrals, compute_molecular_integrals, run_rhf

__all__ = [
    "build_shells", "nuclear_repulsion",
    "MolecularIntegrals", "compute_molecular_integrals", "run_rhf",
]
