"""The pipeline cell on stage 1's connection-table route, at a small size
on the CPU: ``n2-ccpvdz-10o.pipeline`` with its configuration swapped for
H2O/STO-3G (``tests/data/h2o-table.json``) and the dense route's cap held
below its 441 determinants, as one H100's cap (51,548) is below N2
(10e, 10o)'s 63,504.  A sound run is correct on ``table``; each planted
fault and the control are not; the cell's four readers of the program's
stage-1 and SCI spans return None where there is nothing to read."""

from types import SimpleNamespace
from unittest import mock

import pytest

from perfbench import run, tracing
from perfbench.entries import pipeline
from perfbench.tests import small

CELL = "n2-ccpvdz-10o.pipeline"
READERS = ("ctable_build_ms", "local_energy_ms", "local_energy_mfu_pct",
           "sci_score_ms")


def _below_441(self, n_copies=2):
    return 440


def _run(trace=False, fault=None, control=False):
    """A small run of the cell on the table route, and the record of its
    traced solve (None untraced)."""
    from flow_guided_krylov_torch.utils import profiling
    from flow_guided_krylov_torch.utils.memory import MemoryBudget
    profiling.reset()
    traced = []
    solve = tracing.traced_solve

    def kept(*args):
        traced.append(solve(*args))
        return traced[-1]

    with mock.patch.object(MemoryBudget, "dense_hamiltonian_cap",
                           _below_441), \
            mock.patch.object(tracing, "traced_solve", kept):
        r = small.run_small(CELL, trace=trace, fault=fault, control=control)
    return r, traced[0].record if traced else None


def _read(name, ctx):
    return run.load_module(run.HERE / "metrics" / f"{name}.py",
                           f"perfbench_metric_{name}").read(ctx)


def test_sound_run_is_correct_on_the_table_route():
    r, record = _run(trace=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert record["route"] == "table"
    assert record["nqs_widths"] == [14, 32, 32, 1]
    m = r["metrics"]
    # the table build and the SCI scoring are program spans, read on the
    # CPU too; the device readers find no kernels there
    assert m["ctable_build_ms"]["value"] > 0
    assert m["sci_score_ms"]["value"] > 0
    for name in ("local_energy_ms", "local_energy_mfu_pct"):
        assert name not in m, name


@pytest.mark.parametrize("fault", pipeline.FAULTS)
def test_fault_is_not_correct(fault):
    r, _ = _run(fault=fault)
    assert not r["correct"], (fault, r["checks"])


def test_control_is_not_correct():
    r, _ = _run(control=True)
    assert not r["correct"], r["checks"]


def _ctx(snap, kernel_s=None, route="table", on_card=True):
    trace = SimpleNamespace(
        record={"route": route, "nqs_widths": [20] + [512] * 6 + [1]},
        kernel_seconds_in=lambda name: (kernel_s if name ==
                                        "stage1.local_energy" else None))
    return SimpleNamespace(trace=trace, records=[dict(trace.record)],
                           on_card=on_card), snap


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_its_span_or_counter(name):
    """A program without the spans and counters (the parent commit's),
    an untraced run, and a device-free trace: None, never raised."""
    from flow_guided_krylov_torch.utils import profiling
    empty = {"spans": {}, "counters": {}}
    ctx, snap = _ctx(empty, kernel_s=None)
    with mock.patch.object(profiling, "snapshot", lambda: snap):
        assert _read(name, ctx) is None
        assert _read(name, SimpleNamespace(trace=None, records=[],
                                           on_card=False)) is None


def test_device_readers_arithmetic():
    """``local_energy_ms``: the span's kernel time over the steps;
    ``local_energy_mfu_pct``: NQS rows x 2 sum(in * out) over that time
    at the float32 peak, on ``table`` alone; ``sci_score_ms``: the span's
    mean over the scored rounds, host or device."""
    from flow_guided_krylov_torch.utils import profiling
    from perfbench.peaks import F32_FLOP_PER_S
    rows = 6000 * 875 * 250
    snap = {"spans": {"sci.score": {"calls": 4, "total_s": 0.8,
                                    "self_s": 0.8}},
            "counters": {"stage1.steps": 250, "stage1.nqs_rows": rows,
                         "sci.rounds": 4, "sci.device_rounds": 4}}
    ctx, _ = _ctx(snap, kernel_s=60.0)
    flops = rows * 2 * (20 * 512 + 5 * 512 * 512 + 512)
    with mock.patch.object(profiling, "snapshot", lambda: snap):
        assert _read("local_energy_ms", ctx) == pytest.approx(240.0)
        assert _read("local_energy_mfu_pct", ctx) == pytest.approx(
            100.0 * flops / 60.0 / F32_FLOP_PER_S)
        assert _read("sci_score_ms", ctx) == pytest.approx(200.0)
        dense, _ = _ctx(snap, kernel_s=60.0, route="dense")
        assert _read("local_energy_mfu_pct", dense) is None
        del snap["counters"]["sci.device_rounds"]
        assert _read("sci_score_ms", ctx) == pytest.approx(200.0)
        del snap["counters"]["sci.rounds"]
        assert _read("sci_score_ms", ctx) is None
