"""Port parity: the spin pipeline's stage 4 (``FlowGuidedSKQD.run_with_nf``
in a Heisenberg S_z sector, h_z = 0.1 on site 0, Neel start) against the
JAX package's, both given one stage-3 basis (the JAX Selected-CI from the
Neel state).

The two packages draw their shots from different random streams, so the
test feeds the port the JAX run's own uniforms: the evolution, the
sampler and the combination then differ only by rounding.  JAX sums the
sampler's cdf in float32 and the port in float64, and the evolved states
agree to float32 rounding, so a draw within rounding of a cdf boundary may
pick the neighbouring state.  At Heisenberg-12 the final Krylov bases and
the stage-4 gains come out equal; the test allows 3 % of the states and
1 % of the gain.  (The script below measured 2-7 % of the states and
0.2 % of the gain at 16-22 sites.)

Run as a script for the witness at larger sizes (each package with its own
stream, then the port fed JAX's uniforms, then the port with its
propagator's float32 matmuls rounded to bfloat16 inputs, the TPU's default
matmul precision):

    JAX_PLATFORMS=cpu python tests/test_torch_spin_stage4.py \\
        --sites 20 --rounds 10 --per-round 500 --seeds 0,1
"""

import argparse
import json
import time

import jax
import numpy as np
import pytest
import torch

from flow_guided_krylov_tpu.hamiltonians import spin as jspin
from flow_guided_krylov_tpu.krylov import skqd as jskqd
from flow_guided_krylov_tpu.krylov.residual_expansion import (
    ResidualExpansionConfig, SelectedCIExpander)
from flow_guided_krylov_torch import convert
from flow_guided_krylov_torch.krylov import skqd as pskqd

torch.set_num_threads(1)

BASIS_DIFF, GAIN_RTOL = 0.03, 0.01


def stage3_basis(jh, rounds, per_round):
    """The JAX Selected-CI basis after ``rounds`` rounds from Neel."""
    neel = jskqd.SampleBasedKrylovDiagonalization(jh).initial_state
    expander = SelectedCIExpander(jh, ResidualExpansionConfig(
        configs_per_iteration=per_round, max_iterations=rounds,
        max_basis_size=1 + rounds * per_round + 10))
    basis = np.atleast_2d(neel)
    for _ in range(rounds):
        basis = expander.expand_basis(basis)["basis"]
    return neel, basis


class _Bf16Matmul(torch.overrides.TorchFunctionMode):
    """float32 matmuls with their inputs rounded to bfloat16 and a float32
    sum: a TPU's default precision for the JAX propagator's ``@``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", None) == "matmul"
                and all(a.dtype == torch.float32 for a in args[:2])):
            args = tuple(a.bfloat16().float() for a in args[:2])
        return func(*args, **(kwargs or {}))


def _bf16_propagator(mv, psi_re, psi_im, dt, m,
                     impl=pskqd._lanczos_expm_impl):
    with _Bf16Matmul():
        return impl(mv, psi_re, psi_im, dt, m)


def stage4(jh, neel, basis, krylov_dim, shots, seed, monkeypatch,
           bf16=False):
    """run_with_nf of the JAX package and of the port on ``basis``: each
    with its own stream, and the port fed the JAX run's uniforms."""
    ph = convert.spin_hamiltonian_from_jax(jh, "cpu")
    uniforms = []
    jax_counts = jskqd._sample_counts_device

    def recorded(key, re, im, shots_, n):
        uniforms.append(np.array(jax.random.uniform(key, (shots_,))))
        return jax_counts(key, re, im, shots_, n)

    def fed(re, im, shots_, generator):
        idx = pskqd._sample_idx_cdf(re ** 2 + im ** 2,
                                    torch.as_tensor(uniforms.pop(0)))
        return torch.bincount(idx, minlength=re.shape[0])

    out = {}
    with monkeypatch.context() as m:
        m.setattr(jskqd, "_sample_counts_device", recorded)
        out["jax"] = jskqd.FlowGuidedSKQD(
            jh, basis, jskqd.SKQDConfig(max_krylov_dim=krylov_dim,
                                        shots_per_krylov=shots, seed=seed),
            initial_state=neel).run_with_nf()
    runs = [("port", None), ("port fed jax uniforms", fed)]
    if bf16:
        runs.append(("port fed jax uniforms, bf16 matmuls", fed))
    recorded_uniforms = list(uniforms)
    for name, sampler in runs:
        uniforms[:] = recorded_uniforms
        with monkeypatch.context() as m:
            if sampler is not None:
                m.setattr(pskqd, "_sample_counts_device", sampler)
            if "bf16" in name:
                m.setattr(pskqd, "_lanczos_expm_impl", _bf16_propagator)
            out[name] = pskqd.FlowGuidedSKQD(
                ph, basis, pskqd.SKQDConfig(max_krylov_dim=krylov_dim,
                                            shots_per_krylov=shots,
                                            seed=seed),
                initial_state=neel).run_with_nf()
    return out


def gain_mha(run):
    return 1e3 * (run["nf_only_energy"] - run["best_stable_energy"])


def basis_diff(a, b):
    """Share of ``b``'s final Krylov states that ``a`` lacks or adds."""
    ka, kb = a["krylov_bases"][-1][:, 0], b["krylov_bases"][-1][:, 0]
    return len(np.setxor1d(ka, kb)) / len(kb)


@pytest.mark.parametrize("seed", [0, 1])
def test_stage4_fed_the_jax_uniforms_matches_jax(seed, monkeypatch):
    """Heisenberg-12, K = 12: the same sampled bases, combined sizes and
    stage-4 gain as the JAX package from one stage-3 basis."""
    jh = jspin.HeisenbergHamiltonian(12, 1.0, 1.0, 1.0,
                                     h_z=np.array([0.1] + [0.0] * 11))
    neel, basis = stage3_basis(jh, 4, 40)
    out = stage4(jh, neel, basis, 12, 20_000, seed, monkeypatch)
    j, f = out["jax"], out["port fed jax uniforms"]
    assert f["nf_only_energy"] == pytest.approx(j["nf_only_energy"],
                                                abs=1e-10)
    assert basis_diff(f, j) <= BASIS_DIFF
    np.testing.assert_allclose(f["combined_sizes"], j["combined_sizes"],
                               rtol=BASIS_DIFF)
    assert gain_mha(f) == pytest.approx(gain_mha(j), rel=GAIN_RTOL)
    assert gain_mha(j) > 100.0
    # the port's own stream samples the same kind of basis
    assert out["port"]["combined_sizes"][-1] == pytest.approx(
        j["combined_sizes"][-1], rel=0.1)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sites", type=int, default=20)
    p.add_argument("--krylov-dim", type=int, default=12)
    p.add_argument("--shots", type=int, default=100_000)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--per-round", type=int, default=500)
    p.add_argument("--seeds", default="0,1")
    a = p.parse_args()
    torch.set_num_threads(4)
    jh = jspin.HeisenbergHamiltonian(a.sites, 1.0, 1.0, 1.0, h_z=np.array(
        [0.1] + [0.0] * (a.sites - 1)))
    neel, basis = stage3_basis(jh, a.rounds, a.per_round)
    print(json.dumps({"sites": a.sites, "krylov_dim": a.krylov_dim,
                      "shots": a.shots, "stage3_basis": len(basis)}))
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        with pytest.MonkeyPatch.context() as mp:
            out = stage4(jh, neel, basis, a.krylov_dim, a.shots, seed, mp,
                         bf16=True)
        for name, run in out.items():
            print(json.dumps({
                "seed": seed, "run": name,
                "nf_energy": run["nf_only_energy"],
                "stage4_energy": run["best_stable_energy"],
                "gain_mha": gain_mha(run),
                "combined_sizes": run["combined_sizes"],
                "final_basis_diff_vs_jax": basis_diff(run, out["jax"])}))
        print(json.dumps({"seed": seed,
                          "wall_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
