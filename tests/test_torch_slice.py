"""The port's slice end to end on the CPU: HF-seeded Selected-CI (stage 3)
then FlowGuidedSKQD with ELL evolution (stage 4) on LiH/STO-3G, held
against the JAX package running the same slice.

Stage 3 is deterministic host f64 code in both packages, so its basis and
energy must match exactly.  Stage 4 samples from two different RNG streams
(torch.Generator vs jax.random), so the packages are compared
statistically: both final energies lie between FCI - 1e-6 Ha and their
stage-3 energy, and they agree within ``SKQD_TOL``.  Stage 3 stops at
4 determinants, 2.21 mHa above FCI, so stage 4 has work to do.  Over
seeds 0..4 the stage-4 energies of the two packages landed 0.007 to
0.018 mHa above FCI and differed by at most 6.9e-6 Ha; the tolerance of
5e-5 Ha (0.05 mHa) is seven times that and half the 0.1 mHa ceiling.
"""

import numpy as np
import torch

from flow_guided_krylov_tpu.hamiltonians.molecular import \
    create_lih_hamiltonian as jax_lih
from flow_guided_krylov_tpu import krylov as jk
from flow_guided_krylov_torch import krylov as pk
from flow_guided_krylov_torch.hamiltonians.molecular import \
    create_lih_hamiltonian

torch.set_num_threads(1)

SKQD_TOL = 5e-5


def _slice(h, krylov):
    """Stage 3 stopped early (so stage 4 has work), then stage 4."""
    sci = krylov.iterative_residual_expansion(
        h, h.get_hf_state()[None, :],
        krylov.ResidualExpansionConfig(configs_per_iteration=3,
                                       max_iterations=1))
    out = krylov.FlowGuidedSKQD(
        h, sci["basis"],
        krylov.SKQDConfig(evolution="ell", max_krylov_dim=6, time_step=0.5,
                          shots_per_krylov=200_000, seed=0)).run_with_nf()
    return sci, out


def test_lih_stage3_to_stage4_matches_jax():
    jh = jax_lih()
    ph = create_lih_hamiltonian("cpu")
    fci = ph.fci_energy()
    assert abs(fci - jh.fci_energy()) < 1e-9

    j_sci, j_out = _slice(jh, jk)
    p_sci, p_out = _slice(ph, pk)
    np.testing.assert_array_equal(ph.keys(p_sci["basis"]),
                                  jh.keys(j_sci["basis"]))
    assert abs(p_sci["energy"] - j_sci["energy"]) < 1e-9
    assert p_sci["energy"] - fci > 1e-3          # stage 4 has work to do

    for sci, out in ((j_sci, j_out), (p_sci, p_out)):
        e = out["best_stable_energy"]
        assert fci - 1e-6 <= e <= sci["energy"] + 1e-12
        assert out["final_energy"] == e
        assert len(out["combined_sizes"]) == 6
        assert out["combined_sizes"][-1] > len(sci["basis"])
    assert abs(p_out["best_stable_energy"]
               - j_out["best_stable_energy"]) < SKQD_TOL
