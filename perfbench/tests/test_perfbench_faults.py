"""A run at a small size on the CPU, past the look for a card, through
the whole harness: sound, it is correct; with the timed path broken in
each way the cell can be, or with the control (the reference at lower
precision) in the program's place, it is not."""

import pytest

from perfbench.entries import pipeline, trotter_skqd
from perfbench.tests.small import run_small


@pytest.mark.parametrize("workload", ["ch4.pipeline", "tfim28.skqd"])
def test_sound_run_is_correct(workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    for m in ("solve_s", "setup_s"):
        assert r["metrics"][m]["value"] > 0


@pytest.mark.parametrize(
    "workload, fault",
    [("ch4.pipeline", f) for f in pipeline.FAULTS]
    + [("tfim28.skqd", f) for f in trotter_skqd.FAULTS])
def test_fault_is_not_correct(workload, fault):
    r = run_small(workload, fault=fault)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("workload", ["ch4.pipeline", "tfim28.skqd"])
def test_control_is_not_correct(workload):
    r = run_small(workload, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["ch4.pipeline", "tfim28.skqd"])
def test_traced_run_reads_its_per_layer_metrics(workload):
    r = run_small(workload, trace=True)
    assert r["correct"], r["checks"]
    assert "host_eigsh_s" in r["metrics"]
    assert "breakdown" in r


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        run_small("tfim28.skqd", fault="exchange")
