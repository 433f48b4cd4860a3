"""The port stands alone: no module of ``flow_guided_krylov_torch/``, and
not ``chip_smoke.py``, imports the JAX package or JAX itself.  The card's
machine has neither."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("flow_guided_krylov_tpu", "jax", "jaxlib")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "flow_guided_krylov_torch")):
        files += [os.path.join(d, f) for f in sorted(names)
                  if f.endswith(".py")]
    return files


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_the_walk_sees_the_port():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("flow_guided_krylov_torch", "chem", "scf.py") in names
