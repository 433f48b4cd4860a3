"""The port's repaired faults that are not the device PT2 scorer's (that
one is held in ``tests/test_torch_sci_remainders.py``): the oracle
caches' own file names, the propagator's float32 tridiagonal ``eigh``
held to scipy's f64 propagator, and the pipeline's docstring."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from flow_guided_krylov_torch import pipeline as ppipe
from flow_guided_krylov_torch.hamiltonians import (HeisenbergHamiltonian,
                                                   TransverseFieldIsing,
                                                   create_lih_hamiltonian)
from flow_guided_krylov_torch.krylov import skqd as pskqd
from flow_guided_krylov_torch.postprocessing import eigensolver as peig

torch.set_num_threads(1)


def _heis8():
    return HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                                 h_z=np.array([0.1] + [0.0] * 7),
                                 device="cpu")


def test_a_reference_named_oracle_file_is_not_read(tmp_path, monkeypatch):
    """A number under the JAX package's name for the same hash, in the same
    directory, is not returned; the port's own file is, once written."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    h = _heis8()
    skqd = pskqd.SampleBasedKrylovDiagonalization(h)
    path = skqd._oracle_cache_path()
    jax_name = path.parent / path.name[len("torch_"):]
    jax_name.write_text("-999.0")
    e = skqd.exact_subspace_energy()
    assert e == pytest.approx(np.linalg.eigvalsh(h.exact_dense())[0],
                              abs=1e-9)
    assert path.exists() and float(path.read_text()) == e
    tfim = TransverseFieldIsing(6, h=0.5, device="cpu")
    full = peig._fullspace_cache_path(tfim)
    (full.parent / full.name[len("torch_"):]).write_text("-999.0")
    out = peig.exact_fullspace_ground_state(tfim, verbose=False)
    assert out["energy"] == pytest.approx(
        np.linalg.eigvalsh(tfim.exact_dense())[0], abs=1e-8)


def _lih_start():
    h = create_lih_hamiltonian("cpu")
    skqd = pskqd.SampleBasedKrylovDiagonalization(
        h, pskqd.SKQDConfig(evolution="dense"))
    return skqd, h.get_hf_state()


def _heis8_start():
    h = _heis8()
    skqd = pskqd.SampleBasedKrylovDiagonalization(
        h, pskqd.SKQDConfig(evolution="dense"))
    return skqd, skqd.initial_state


@pytest.mark.parametrize("system", [_lih_start, _heis8_start],
                         ids=["lih", "heisenberg8"])
def test_propagator_against_expm_multiply(system):
    """One 30-step Lanczos evolve (the tridiagonal diagonalized in float32)
    against scipy's f64 ``expm_multiply``: a relative 2-norm under the
    1e-5 past which the tridiagonal would need float64 (the card's float32
    cuSOLVER ``eigh`` is what ``chip_smoke.py`` measures)."""
    skqd, start = system()
    psi = np.zeros(skqd.dim, complex)
    psi[skqd._index_of(start)[0]] = 1.0
    want = spla.expm_multiply(-1j * 0.1 * skqd.subspace_hamiltonian, psi)
    re, im = skqd._psi_to_device(psi)
    H = skqd._device_hamiltonian()
    out_r, out_i = pskqd._lanczos_expm_impl(lambda v: v @ H.T, re, im, 0.1,
                                            30)
    got = out_r.numpy() + 1j * out_i.numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_propagator_diagonalizes_in_float32(monkeypatch):
    """The tridiagonal's ``eigh`` is float32, the one precision the
    propagator has."""
    seen = []
    eigh = torch.linalg.eigh

    def spy(T):
        seen.append(T.dtype)
        return eigh(T)

    monkeypatch.setattr(torch.linalg, "eigh", spy)
    skqd, start = _heis8_start()
    psi = np.zeros(skqd.dim, complex)
    psi[skqd._index_of(start)[0]] = 1.0
    re, im = skqd._psi_to_device(psi)
    H = skqd._device_hamiltonian()
    pskqd._lanczos_expm_impl(lambda v: v @ H.T, re, im, 0.1, 10)
    assert seen == [torch.float32]


def test_pipeline_docstring_lists_only_what_still_raises():
    doc = " ".join(ppipe.__doc__.split())
    raising = doc.split("Branches not ported")[1]
    assert "restricted-subspace stage 4" not in doc
    assert "spin Hamiltonians" not in raising
    for still in ("use_local_energy=False", "checkpointing",
                  "use_particle_conserving_flow=False"):
        assert still in raising, still
    # more than one device is ported (the mesh, parallel/)
    assert "more than one device" not in raising
