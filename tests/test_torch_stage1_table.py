"""Stage 1 on the connection-table route against the benchmark's plain
float64 reference (``perfbench/reference/``), on the CPU.

NH3/STO-3G (8 orbitals, 5 alpha + 5 beta: 3,136 determinants, 315
connections a row) with ``MemoryBudget.dense_hamiltonian_cap`` held below
3,136, so the trainer takes ``table``, as N2/cc-pVDZ (10e, 10o) does on
one H100 (cap 51,548 against 63,504 determinants).  On seeded random
weights:

* the table route's local energies are (H psi)(x) / psi(x) over the whole
  space in float64, and equal the ``dense`` and ``fly`` routes';
* one first step's energy and clipped NQS gradient norms are the
  reference's ``first_step``;
* the benchmark's configuration ``n2-ccpvdz-10o`` is what the CLI runs:
  its pipeline settings, its integrals and its space.
"""

import dataclasses
import functools
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from flow_guided_krylov_torch.flows import physics_guided_training as ppg
from flow_guided_krylov_torch.flows.particle_conserving import \
    ParticleConservingFlow
from flow_guided_krylov_torch.hamiltonians.molecular import \
    create_nh3_hamiltonian
from flow_guided_krylov_torch.models.dense import DenseNQS
from flow_guided_krylov_torch.ops.bits import to_device, unpack_np
from flow_guided_krylov_torch.pipeline import (FlowGuidedKrylovPipeline,
                                               PipelineConfig)
from flow_guided_krylov_torch.utils.memory import MemoryBudget
from perfbench.reference import nqs as ref_nqs
from perfbench.reference import slater

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_ORB, N_ALPHA, N_BETA = 8, 5, 5
HIDDEN = (64, 64, 64)
B = 128
# E_loc of NH3 is ~ -56 Ha: the table's float32 diagonal alone is one ulp
# (3.8e-6) off, and each of the 315 float32 elements times a float32
# ratio exp(la_y - la_x) adds its own rounding; 2e-6 of |E_loc|
# (~1.1e-4 Ha, about 30 ulps) holds them with room and is still ~1000x
# below a wrong connection (|H_xy| ~ 0.1 Ha)
ELOC_RTOL = 2e-6
# the step's energy is a softmax-weighted mean of those E_loc: the
# float32 limit on stage 1's first energy of ``ch4.pipeline`` (1.5e-5 Ha)
ENERGY_ATOL = 1.5e-5
# each leaf's clipped gradient norm, relative to the larger of its own
# and the median leaf's: ``ch4.pipeline``'s float32 limit (1e-4)
GRAD_RTOL = 1e-4


N_VALID = 3136


def _below_n(self, n_copies=2):
    """``MemoryBudget.dense_hamiltonian_cap`` held below the space."""
    return N_VALID - 1


@functools.lru_cache(maxsize=None)
def _ham():
    return create_nh3_hamiltonian("cpu")


@functools.lru_cache(maxsize=None)
def _reference():
    """Every determinant in the program's enumeration order and H over
    them in float64 (the reference's own Slater-Condon rules)."""
    h = _ham()
    i = h.integrals
    dets = h.enumerate_basis().astype(np.int64)
    H = slater.projected_hamiltonian(dets, N_ORB, N_ALPHA, N_BETA,
                                     np.asarray(i.h1e, np.float64),
                                     np.asarray(i.h2e, np.float64),
                                     float(i.nuclear_repulsion))
    return dets, H


def _trainer(route, seed=5):
    """The stage-1 trainer as the pipeline configures it, with the dense
    cap held below the space: ``table``, or ``fly`` without the table,
    or ``dense`` at the cap itself."""
    h = _ham()
    cap = (N_VALID if route == "dense"
           else MemoryBudget.for_device("cpu").dense_hamiltonian_cap())
    cfg = ppg.PhysicsGuidedConfig(
        samples_per_batch=B, dense_local_energy_max_dim=cap,
        use_connection_table=route != "fly", num_epochs=10, seed=seed,
        verbose=False)
    return ppg.PhysicsGuidedFlowTrainer(
        h, ParticleConservingFlow(N_ORB, N_ALPHA, N_BETA, (32, 32)),
        DenseNQS(2 * N_ORB, HIDDEN), cfg)


def _batch(seed=11):
    """B distinct determinants of the space, as (B, 2) words."""
    dets, _ = _reference()
    rng = np.random.default_rng(seed)
    return dets[np.sort(rng.choice(len(dets), B, replace=False))]


def _params(trainer):
    return {k: v.detach().double().numpy()
            for k, v in trainer.nqs.named_parameters()}


def test_table_route_taken_below_the_dense_cap():
    """The pipeline's own trainer takes ``table`` when the dense cap is
    below the space, and ``dense`` when it is not; the table holds every
    determinant's 315 connections."""
    h = _ham()
    assert h.n_valid_configs == N_VALID and h.n_connections == 315
    routes = {}
    for held in (True, False):
        cfg = PipelineConfig(max_epochs=1, min_epochs=1,
                             samples_per_batch=64, verbose=False, seed=2)
        with mock.patch.object(MemoryBudget, "dense_hamiltonian_cap",
                               _below_n if held else
                               MemoryBudget.dense_hamiltonian_cap):
            pipe = FlowGuidedKrylovPipeline(h, cfg)
            pipe.train_flow_nqs()
        routes[held] = pipe.trainer.route
        t = pipe.trainer.connection_table
        assert (t.n_configs, t.n_connections) == (N_VALID, 315)
    assert routes == {True: "table", False: "dense"}
    with mock.patch.object(MemoryBudget, "dense_hamiltonian_cap", _below_n):
        assert _trainer("table").route == "table"


@pytest.mark.parametrize("seed", [5, 6])
def test_table_local_energies_are_the_reference(seed):
    dets, H = _reference()
    with mock.patch.object(MemoryBudget, "dense_hamiltonian_cap", _below_n):
        tr = _trainer("table", seed)
    packed = _batch(seed)
    occ = torch.from_numpy(unpack_np(packed.astype(np.uint32), N_ORB)
                           ).float()
    with torch.no_grad():
        la_x = tr.nqs(occ)
        got = tr.local_energies(to_device(packed.astype(np.uint32), "cpu"),
                                la_x).double().numpy()
    # the reference: psi over the whole space in float64, H psi / psi
    params = [(k, torch.from_numpy(v)) for k, v in _params(tr).items()]
    occ_all = torch.from_numpy(ref_nqs.occupations(dets, N_ORB))
    with torch.no_grad():
        la = ref_nqs.log_amplitudes(params, occ_all, tf32=False).numpy()
    psi = np.exp(la - la.max())
    hpsi = H @ psi
    key = (dets[:, 0] << 32) | dets[:, 1]
    order = np.argsort(key)
    rows = order[np.searchsorted(key[order],
                                 (packed[:, 0] << 32) | packed[:, 1])]
    want = hpsi[rows] / psi[rows]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ELOC_RTOL * np.abs(want).max())


def test_table_local_energies_equal_the_other_routes():
    packed = to_device(_batch(3).astype(np.uint32), "cpu")
    got = {}
    for route in ("table", "dense", "fly"):
        with mock.patch.object(MemoryBudget, "dense_hamiltonian_cap",
                               _below_n):
            tr = _trainer(route)
        assert tr.route == route
        occ = torch.from_numpy(unpack_np(packed.numpy().astype(np.uint32),
                                         N_ORB)).float()
        with torch.no_grad():
            got[route] = tr.local_energies(packed, tr.nqs(occ)).numpy()
    scale = np.abs(got["table"]).max()
    np.testing.assert_allclose(got["table"], got["fly"], rtol=0,
                               atol=ELOC_RTOL * scale)
    np.testing.assert_allclose(got["table"], got["dense"], rtol=0,
                               atol=ELOC_RTOL * scale)


@pytest.mark.parametrize("seed", [1, 8])
def test_first_table_step_is_the_reference(seed):
    """One step on the flow's own samples: the energy it reports and the
    clipped NQS gradient the optimizer got (its first moment over
    1 - b1), against ``perfbench/reference/nqs.first_step``."""
    dets, H = _reference()
    with mock.patch.object(MemoryBudget, "dense_hamiltonian_cap", _below_n):
        tr = _trainer("table", seed)
    params = _params(tr)
    configs = tr.sample(1.0)
    energy = float(tr.update(configs)[0])
    opt = tr.nqs_opt
    got = {k: float(np.linalg.norm(m.double().numpy())) / (1.0 - opt.b1)
           for (k, _), m in zip(tr.nqs.named_parameters(), opt.mu)}
    e_ref, norms = ref_nqs.first_step(params, configs.numpy(), dets, H,
                                      N_ORB, opt.max_norm)
    assert abs(energy - e_ref) < ENERGY_ATOL
    floor = float(np.median(list(norms.values())))
    for k, v in norms.items():
        assert abs(got[k] - v) / max(v, floor) < GRAD_RTOL, k


# -- the benchmark's configuration n2-ccpvdz-10o ---------------------------

def _config():
    return json.loads(
        (ROOT / "perfbench/configs/n2-ccpvdz-10o.json").read_text())


def test_config_pipeline_is_the_clis_after_tiering():
    """``large_system_benchmark --system n2_ccpvdz_10o`` (pipeline mode,
    FAST): ``SystemScaler`` then the pipeline's tiering.  The file holds
    every field that differs from ``PipelineConfig()``, at its value."""
    from flow_guided_krylov_torch.utils.system_scaler import (QualityPreset,
                                                             SystemScaler)
    conf = _config()
    cfg = SystemScaler(conf["n_determinants"], QualityPreset("fast")
                       ).create_pipeline_config(verbose=False)
    cfg.adapt_to_system_size(conf["n_determinants"])
    as_run = dataclasses.asdict(cfg)
    default = dataclasses.asdict(PipelineConfig())
    changed = {k for k, v in as_run.items()
               if v != default[k] and k != "verbose"}
    assert changed <= set(conf["pipeline"])
    assert {k: as_run[k] for k in conf["pipeline"]} == conf["pipeline"]
    assert cfg.nqs_hidden_dims == [512] * 6
    assert cfg.samples_per_batch == 6000


def test_config_integrals_and_space_are_the_clis():
    from flow_guided_krylov_torch.examples.large_system_benchmark import \
        SYSTEMS
    conf = _config()
    h = SYSTEMS["n2_ccpvdz_10o"]("cpu")
    h1, h2, e_nuc = slater.load_integrals(str(ROOT / conf["integrals"]))
    i = h.integrals
    np.testing.assert_array_equal(h1, i.h1e)
    np.testing.assert_array_equal(h2, i.h2e)
    assert e_nuc == float(i.nuclear_repulsion)
    assert (h.n_orbitals, h.n_alpha, h.n_beta) == (
        conf["n_orbitals"], conf["n_alpha"], conf["n_beta"])
    assert h.n_valid_configs == conf["n_determinants"] == 63504
    assert h.n_connections == conf["n_connections"] == 875
    assert abs(conf["fci_energy"] - conf["fci_energy_published"]) < 1e-6
    # one H100 80GB (85,031,714,816 bytes): the dense route's cap is below
    # the space, and the table fits its budget
    mem = MemoryBudget(85_031_714_816)
    assert mem.dense_hamiltonian_cap() == 51548 < conf["n_determinants"]
    assert (conf["n_determinants"] * conf["n_connections"]
            <= mem.connection_table_entries())
