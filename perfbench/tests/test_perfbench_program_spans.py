"""The per-layer metrics that read the program's own spans and counters
(``flow_guided_krylov_torch/utils/profiling.py``), on small traced runs
of ``tfim28.skqd`` on the CPU: each reads a number, and the benchmark's
own host-eigensolve timer still catches the program's ``eigsh``."""

import json
from unittest import mock

from perfbench import run, tracing
from perfbench.tests import small

SPAN_METRICS = ("project_s", "basis_ms", "trotter_build_ms", "sample_ms")


def _traced(manifest=None):
    import torch
    from flow_guided_krylov_torch.utils import profiling
    torch.set_num_threads(4)
    run.fixed_environment()
    profiling.reset()
    traced = []
    solve = tracing.traced_solve

    def kept(*args):
        traced.append(solve(*args))
        return traced[-1]

    with mock.patch.object(tracing, "traced_solve", kept):
        r = run.run_cell(manifest or small.manifest(), "tfim28.skqd",
                         small.SEED, 1.0, True, device="cpu",
                         require_chip=False)
    assert r["correct"], r["checks"]
    # the traced solve's own record: its host eigensolves under the
    # benchmark's timer, while the program's tracer was recording
    return r, profiling.snapshot(), traced[0].record


def test_traced_run_reads_the_program_spans():
    r, snap, record = _traced()
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in SPAN_METRICS:
        assert m[name] >= 0, name
    assert m["sample_ms"] > 0 and m["trotter_build_ms"] > 0
    assert m["eigsh_matvecs"] >= 0
    # the chain's small basis: a dense eigh below 2048 states
    assert snap["spans"]["skqd.run"]["calls"] == 1
    if "eigsh" not in snap["spans"]:
        assert m["eigsh_matvecs"] == 0 and "eigsh_matvec_ms" not in m
    assert m["host_eigsh_s"] > 0 and record["host_eigensolve_s"] > 0


def test_eigsh_through_the_counted_operator_is_still_timed(tmp_path):
    """A basis above 2048 states (h = 1, dt = 0.3: 3,000 and more) takes
    the sparse ``eigsh``: the benchmark's patch of SciPy's ``eigsh``
    still catches the program's call through its ``LinearOperator``."""
    conf = json.loads((run.REPO / small.SMALL["tfim28"]).read_text())
    conf.update(h=1.0, time_step=0.3)
    path = tmp_path / "tfim12-wide.json"
    path.write_text(json.dumps(conf))
    manifest = small.manifest()
    for c in manifest["configs"]:
        if c["name"] == "tfim28":
            c["file"] = str(path)
    r, snap, record = _traced(manifest)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert snap["spans"]["eigsh"]["calls"] == 1
    assert m["eigsh_matvecs"] > 0
    assert m["eigsh_matvec_ms"] > 0
    assert m["host_eigsh_s"] > 0
    assert 0 < record["host_eigensolve_s"] <= snap["spans"]["eigsh"][
        "total_s"]
