"""flow_guided_krylov_torch — the PyTorch/CUDA port of flow_guided_krylov_tpu.

The JAX package beside it is the reference.  This package imports
``torch``, NumPy and SciPy, and from the JAX package only
``flow_guided_krylov_tpu.chem`` (host NumPy integrals plus the C++ ERI
engine), so it runs on a machine without JAX.

Every device computation runs on the device of the Hamiltonian it is given
(``MolecularHamiltonian(integrals, device=...)``); nothing picks a device
silently.  Float32 matrix products keep full precision: TF32 is never
enabled, as the JAX package's ``Precision.HIGHEST`` rule requires.
"""

__version__ = "0.1.0"
