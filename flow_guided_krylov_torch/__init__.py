"""flow_guided_krylov_torch — the PyTorch/CUDA port of flow_guided_krylov_tpu.

The JAX package beside it is the reference.  This package imports
``torch``, NumPy and SciPy and nothing of the JAX package: it keeps its
own copy of the host chemistry (``chem/``, NumPy integrals plus the
shared C++ ERI engine in ``native/``), so it runs on a machine without
JAX.

Every device computation runs on the device of the Hamiltonian it is given
(``MolecularHamiltonian(integrals, device=...)``); nothing picks a device
silently.  Float32 matrix products keep full precision: TF32 is never
enabled, as the JAX package's ``Precision.HIGHEST`` rule requires.
"""

__version__ = "0.1.0"

__all__ = ["FlowGuidedKrylovPipeline", "PipelineConfig"]


def __getattr__(name):
    # lazy, as in the JAX package: ``import flow_guided_krylov_torch``
    # stays light
    if name in ("FlowGuidedKrylovPipeline", "PipelineConfig",
                "run_molecular_benchmark"):
        from . import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)
