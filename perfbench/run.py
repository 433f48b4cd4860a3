"""Run one benchmark cell once and print its result line.

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and metrics are found by
the names ``BENCHMARK.json`` gives them:

* ``perfbench/configs/<config>.json``: the system and its solver settings;
* ``perfbench/traffic/<traffic>.json``: the mix, whose ``entry`` names the
  solve runner ``perfbench/entries/<entry>.py``;
* ``perfbench/cells/<cell>.json``: the limits of the correctness check;
* ``perfbench/metrics/<metric>.py``: one reader per metric.

A run sets up (inputs, the program's state, one warm-up of the cell's own
shapes), then starts solves back to back while fewer than ``--seconds``
have passed; the window ends when the last solve ends.  With ``--trace 1``
it then runs one more solve under ``torch.profiler``.  Once the program's
state is freed, the plain reference under ``perfbench/reference/`` checks
every solve of the window.  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error and the last key of that object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CACHE = HERE / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "flow_guided_krylov_tpu")


def fixed_environment() -> None:
    """Every cache the program or its libraries keep goes to a fixed
    directory inside the checkout; no library may load JAX."""
    os.environ["FGK_INTEGRAL_CACHE"] = str(CACHE / "integrals")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    CACHE.mkdir(parents=True, exist_ok=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(manifest: dict, workload: str) -> SimpleNamespace:
    """The cell's entries of the manifest and the files they name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf = configs[w["config"]]
    config = read_json(REPO / conf["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = read_json(HERE / "cells" / f"{workload}.json")

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in manifest["end_to_end"] if listed(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return SimpleNamespace(name=workload, chips=int(w["chips"]),
                           config=config, traffic=traffic,
                           limits=limits["limits"], end_to_end=e2e,
                           per_layer=per_layer)


def solve_seed(seed: int, i: int) -> int:
    """The i-th solve's seed, drawn from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), i])
    return int(ss.generate_state(1, np.uint32)[0])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_metrics(metrics, ctx) -> dict:
    out = {}
    for m in metrics:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             f"perfbench_metric_{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(manifest: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", require_chip: bool = True,
             fault: str = None, control: bool = False,
             t_start: float = None) -> dict:
    """One run of one cell: the result object (``checks`` last).
    ``fault`` breaks the timed path in a named way and ``control`` puts
    the reference, at lower precision, in the program's place: both are
    for the benchmark's own tests and readings, never for a timed run."""
    t_start = T_START if t_start is None else t_start
    spec = cell_spec(manifest, workload)
    import torch
    if require_chip:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < spec.chips:
            raise SystemExit(f"{workload} needs {spec.chips} cards, "
                             f"{torch.cuda.device_count()} present")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    from perfbench import tracing
    entry = load_module(HERE / "entries" / f"{spec.traffic['entry']}.py",
                        f"perfbench_entry_{spec.traffic['entry']}")
    cell = entry.Cell(spec, dev, seed=seed, trace=trace, fault=fault,
                      cache=CACHE)
    cell.setup()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    records, failed, attempted = [], 0, 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        attempted += 1
        t0 = time.perf_counter()
        try:
            records.append(cell.solve(solve_seed(seed, attempted)))
        except Exception:  # a failed solve is counted, and the run goes on
            failed += 1
            traceback.print_exc()
        print(f"solve {attempted}: seed {solve_seed(seed, attempted)}, "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    window_s = time.perf_counter() - w0
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0

    summary = None
    if trace:
        summary = tracing.traced_solve(
            cell, solve_seed(seed, attempted + 1), on_card)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    cell.release()

    checks = {k: {"value": float(c["value"]), "limit": float(c["limit"])}
              for k, c in cell.check(records, seed, control=control).items()}
    correct = (bool(records) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    ctx = SimpleNamespace(records=records, window_s=window_s,
                          setup_s=setup_s, peak_bytes=peak, trace=summary,
                          spec=spec, cell=cell, on_card=on_card)
    metrics = read_metrics(spec.per_layer if trace else spec.end_to_end,
                           ctx)
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "count": spec.chips if on_card else 0,
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None,
                   help="break the timed path (the benchmark's own "
                        "fault readings only)")
    p.add_argument("--control", action="store_true",
                   help="the reference at lower precision in the "
                        "program's place (the control's readings only)")
    args = p.parse_args(argv)
    fixed_environment()
    manifest = read_json(REPO / "BENCHMARK.json")
    sys.path.insert(0, str(REPO))
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), fault=args.fault,
                      control=args.control)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
