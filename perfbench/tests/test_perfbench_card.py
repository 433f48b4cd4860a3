"""One short run of each cell on the card, through the command the
manifest names; skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tfim28.skqd"])
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs one cell on the card")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cmd = manifest["command"] + ["--workload", workload, "--seed",
                                 "4294967311", "--seconds", "3",
                                 "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
