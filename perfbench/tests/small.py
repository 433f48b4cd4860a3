"""The benchmark's manifest with each configuration swapped for a small
one of the same kind, for runs on the CPU: H2O/STO-3G through the
pipeline at small widths, and a 12-site chain through the Trotter path.
The cells, traffic mixes, limits and readers are the real ones.

The pipeline cell is withheld from ``BENCHMARK.json`` while the program
can stall in its stage-1 diagnostic (PERF.md, Open questions); its
entries are added back here, so that its runner, check and readers stay
tested until it returns."""

import copy

from perfbench import run

SMALL = {"ch4-sto3g": "perfbench/tests/data/h2o-small.json",
         "tfim28": "perfbench/tests/data/tfim12.json"}
SEED = 12345678901          # past 32 bits, as a run's seed may be

WITHHELD_CONFIG = {"name": "ch4-sto3g", "file": SMALL["ch4-sto3g"]}
WITHHELD_CELL = {"name": "ch4.pipeline", "config": "ch4-sto3g",
                 "traffic": "pipeline", "chips": 1}
WITHHELD_LAYERS = ("stage1_s", "epoch_ms", "stage1_mfu_pct")
SHARED_LAYERS = ("host_eigsh_s", "device_idle_pct")


def manifest() -> dict:
    m = copy.deepcopy(run.read_json(run.REPO / "BENCHMARK.json"))
    if "ch4.pipeline" not in {w["name"] for w in m["workloads"]}:
        m["configs"].append(dict(WITHHELD_CONFIG))
        m["workloads"].append(dict(WITHHELD_CELL))
        for metric in m["per_layer"]:
            if metric["name"] in SHARED_LAYERS:
                metric["workloads"].append("ch4.pipeline")
        m["per_layer"] += [{"name": name, "unit": "", "moves": "solve_s",
                            "workloads": ["ch4.pipeline"]}
                           for name in WITHHELD_LAYERS]
    for c in m["configs"]:
        c["file"] = SMALL[c["name"]]
    return m


def run_small(workload, seed=SEED, seconds=1.0, trace=False, fault=None,
              control=False) -> dict:
    """One run of a cell at its small size on the CPU, past the look for
    a card."""
    import torch
    torch.set_num_threads(4)
    run.fixed_environment()
    return run.run_cell(manifest(), workload, seed, seconds, trace,
                        device="cpu", require_chip=False, fault=fault,
                        control=control)
