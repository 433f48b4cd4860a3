"""Carry the JAX package's state into the port.

The system's "weights" are its integral tables, the ELL structure of the
subspace Hamiltonian, a spin Hamiltonian's couplings, and the stage-1
networks' parameters.  These functions take them as NumPy arrays (or any
object exposing the same fields; a flax params tree as nested dicts of
NumPy arrays), so both packages can compute from identical inputs;
nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .ops.excitations import ExcitationSpec
from .ops.slater import SlaterTables

__all__ = ["tables_from_jax", "ell_from_jax", "spin_hamiltonian_from_jax",
           "dense_nqs_state_dict", "complex_nqs_state_dict",
           "rbm_state_dict", "orbital_scorer_state_dict",
           "particle_flow_state_dict", "sz_flow_state_dict",
           "discrete_flow_state_dict", "adam_state_dict",
           "load_trainer_from_jax"]

_TABLE_FIELDS = ("n_orb", "n_alpha", "n_beta", "e_nuc", "h1", "h2", "jj",
                 "ex", "jmat", "kmat", "spec_a", "spec_b", "ab_grid")


def _get(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _spec(obj: Any) -> ExcitationSpec:
    return ExcitationSpec(n_orb=int(_get(obj, "n_orb")), k=int(_get(obj, "k")),
                          singles=np.asarray(_get(obj, "singles"), np.int32),
                          doubles=np.asarray(_get(obj, "doubles"), np.int32))


def tables_from_jax(obj: Any) -> SlaterTables:
    """The port's ``SlaterTables`` from an object or dict holding the JAX
    ``SlaterTables`` fields (``spec_a``/``spec_b`` likewise, with
    ``n_orb``, ``k``, ``singles``, ``doubles``)."""
    f = {name: _get(obj, name) for name in _TABLE_FIELDS}
    return SlaterTables(
        n_orb=int(f["n_orb"]), n_alpha=int(f["n_alpha"]),
        n_beta=int(f["n_beta"]), e_nuc=float(f["e_nuc"]),
        h1=np.asarray(f["h1"], np.float64), h2=np.asarray(f["h2"], np.float64),
        jj=np.asarray(f["jj"], np.float64), ex=np.asarray(f["ex"], np.float64),
        jmat=np.asarray(f["jmat"], np.float64),
        kmat=np.asarray(f["kmat"], np.float64),
        spec_a=_spec(f["spec_a"]), spec_b=_spec(f["spec_b"]),
        ab_grid=np.asarray(f["ab_grid"], np.int32))


def ell_from_jax(diag: np.ndarray, elems_t: np.ndarray, tgt_t: np.ndarray,
                 device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ELL (diag (N,), elems_t (C, N), tgt_t (C, N)) as contiguous
    float32 / float32 / int32 tensors on ``device``."""
    def put(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    return (put(diag, torch.float32), put(elems_t, torch.float32),
            put(tgt_t, torch.int32))


def spin_hamiltonian_from_jax(obj: Any, device):
    """The port's spin Hamiltonian on ``device`` rebuilt from a JAX
    ``TransverseFieldIsing`` or ``HeisenbergHamiltonian`` (or any object
    of a class of the same name with the same fields)."""
    from .hamiltonians.spin import HeisenbergHamiltonian, TransverseFieldIsing
    kind = type(obj).__name__
    n = int(obj.n_sites)
    if kind == "TransverseFieldIsing":
        return TransverseFieldIsing(n, V=float(obj.V), h=float(obj.h),
                                    L=int(obj.L), periodic=bool(obj.periodic),
                                    device=device)
    if kind == "HeisenbergHamiltonian":
        return HeisenbergHamiltonian(
            n, Jx=float(obj.Jx), Jy=float(obj.Jy), Jz=float(obj.Jz),
            h_x=np.array(obj.h_x, np.float64),
            h_y=np.array(obj.h_y, np.float64),
            h_z=np.array(obj.h_z, np.float64),
            periodic=bool(obj.periodic), device=device)
    raise TypeError(f"no port counterpart for spin Hamiltonian {kind}")


def _flax_params(tree: Dict) -> Dict:
    """The ``params`` collection of a flax variables dict (or the dict
    itself when it is already that collection)."""
    return tree["params"] if "params" in tree else tree


def _linear(prefix: str, dense: Dict) -> Dict[str, torch.Tensor]:
    """flax ``Dense`` {kernel (in, out), bias (out,)} -> ``nn.Linear``
    {weight (out, in), bias (out,)}."""
    return {prefix + "weight": torch.tensor(np.asarray(dense["kernel"]).T),
            prefix + "bias": torch.tensor(np.asarray(dense["bias"]))}


def _dense_layers(p: Dict) -> Dict[str, torch.Tensor]:
    """flax ``Dense_i`` -> ``dense.i`` for every i."""
    out = {}
    for i in range(sum(1 for k in p if k.startswith("Dense_"))):
        out.update(_linear(f"dense.{i}.", p[f"Dense_{i}"]))
    return out


def dense_nqs_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``DenseNQS`` or ``SignedDenseNQS`` params tree -> the port's
    model's ``state_dict`` (``Dense_i`` -> ``dense.i``).

    A ``SignedDenseNQS`` tree that flax created through
    ``init(..., method=phase)`` has no ``log_amp_scale`` (its ``__call__``
    then raises ``ScopeParamNotFoundError``); the state dict lacks it too,
    so a strict ``load_state_dict`` refuses it (ROADMAP.md, Queue 3)."""
    p = _flax_params(tree)
    out = _dense_layers(p)
    if "log_amp_scale" in p:
        out["log_amp_scale"] = torch.tensor(np.asarray(p["log_amp_scale"]))
    return out


def complex_nqs_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``ComplexNQS`` params tree -> the port's ``ComplexNQS``
    ``state_dict`` (trunk and both heads, ``Dense_i`` -> ``dense.i``)."""
    return _dense_layers(_flax_params(tree))


def rbm_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``RBMQuantumState`` params tree -> the port's
    ``state_dict`` (the same names)."""
    return {k: torch.tensor(np.asarray(v))
            for k, v in _flax_params(tree).items()}


def orbital_scorer_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``OrbitalScoringNetwork`` params tree -> the port's
    ``state_dict`` (``Dense_i`` -> ``dense.i``, ``prior_logits``)."""
    p = _flax_params(tree)
    out = _dense_layers(p)
    out["prior_logits"] = torch.tensor(np.asarray(p["prior_logits"]))
    return out


def particle_flow_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``ParticleConservingFlow`` params tree -> the port's
    ``ParticleConservingFlow`` ``state_dict`` (same layer names)."""
    p = _flax_params(tree)
    out = {"alpha_prior_logits":
           torch.tensor(np.asarray(p["alpha_prior_logits"]))}
    for name in ("a2b_in", "a2b_out", "beta_h0", "beta_h1", "beta_out"):
        out.update(_linear(name + ".", p[name]))
    return out


def sz_flow_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``SzConservingFlow`` params tree -> the port's
    ``SzConservingFlow`` ``state_dict`` (``site_logits``)."""
    p = _flax_params(tree)
    return {"site_logits": torch.tensor(np.asarray(p["site_logits"]))}


def discrete_flow_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``DiscreteFlowSampler`` params tree -> the port's
    ``DiscreteFlowSampler`` ``state_dict`` (``coupling_i/Dense_j`` ->
    ``couplings.i.dense.j``)."""
    p = _flax_params(tree)
    out = {}
    n_layers = sum(1 for k in p if k.startswith("coupling_"))
    for i in range(n_layers):
        for j in range(4):
            out.update(_linear(f"couplings.{i}.dense.{j}.",
                               p[f"coupling_{i}"][f"Dense_{j}"]))
    return out


def _adam_state(state: Any):
    """The optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an
    optimizer state of nested tuples."""
    if all(hasattr(state, a) for a in ("count", "mu", "nu")):
        return state
    if isinstance(state, tuple):
        for sub in state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def adam_state_dict(opt_state: Any, to_state_dict, module: torch.nn.Module
                    ) -> Dict[str, Any]:
    """An optax state holding one ``ScaleByAdamState`` (``chain(clip,
    adam)``, ``chain(clip, adamw(...))``) -> the port's ``OptaxAdamW``
    state for ``module``'s parameters: the moments as lists in
    ``module.parameters()`` order (``to_state_dict`` converts a moment
    tree as it converts the params tree), and the count."""
    st = _adam_state(opt_state)
    if st is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    mu, nu = to_state_dict(st.mu), to_state_dict(st.nu)
    names = [name for name, _ in module.named_parameters()]
    return {"mu": [mu[n] for n in names], "nu": [nu[n] for n in names],
            "count": int(np.asarray(st.count))}


def load_trainer_from_jax(trainer, jax_trainer) -> None:
    """Start a port ``FlowNQSTrainer`` or ``PhysicsGuidedFlowTrainer``
    (particle flow + ``DenseNQS``) from a JAX trainer of the same class
    and widths: both networks' params and both Adam states, and a
    ``PhysicsGuidedFlowTrainer``'s accumulated basis (its host rows, kept
    in the port's device key buffer ``_acc_keys`` / ``_acc_count``)."""
    for name, conv in (("flow", particle_flow_state_dict),
                       ("nqs", dense_nqs_state_dict)):
        module = getattr(trainer, name)
        module.load_state_dict(conv(getattr(jax_trainer, name + "_params")))
        getattr(trainer, name + "_opt").load_state_dict(adam_state_dict(
            getattr(jax_trainer, name + "_opt_state"), conv, module))
    if hasattr(jax_trainer, "_acc_buf"):
        basis = jax_trainer.accumulated_basis
        cap = trainer.config.max_accumulated_basis
        if basis is not None and len(basis) > cap:
            raise ValueError(f"{len(basis)} accumulated configurations do "
                             f"not fit the port trainer's cap of {cap}")
        trainer.accumulated_basis = basis
