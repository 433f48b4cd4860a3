"""BENCHMARK.json names only files the harness finds, and keeps to the
shape the harness reads."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["perfbench"]


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(w):
    configs = {c["name"]: c for c in M["configs"]}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert (ROOT / configs[w["config"]]["file"]).is_file()
    traffic = json.loads(
        (ROOT / "perfbench/traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "perfbench/entries" / f"{traffic['entry']}.py").is_file()
    limits = json.loads(
        (ROOT / "perfbench/cells" / f"{w['name']}.json").read_text())
    assert limits["limits"]


@pytest.mark.parametrize("m", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_its_reader(m):
    assert NAME.match(m["name"])
    assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").is_file()
    names = {w["name"] for w in M["workloads"]}
    assert set(m.get("workloads", names)) <= names


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in M["per_layer"])
