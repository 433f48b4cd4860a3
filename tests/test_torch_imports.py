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
    for part in (("chem", "scf.py"), ("pipeline.py",), ("models", "dense.py"),
                 ("flows", "particle_conserving.py"),
                 ("flows", "physics_guided_training.py"),
                 ("flows", "discrete.py"), ("flows", "spin_training.py"),
                 ("postprocessing", "diversity_selection.py"),
                 ("utils", "profiling.py"), ("utils", "system_scaler.py"),
                 ("chem", "ccsd.py"), ("ops", "brute_force.py"),
                 ("postprocessing", "projected_hamiltonian.py"),
                 ("postprocessing", "utils.py"),
                 ("parallel", "mesh.py"), ("parallel", "sharded_matvec.py"),
                 ("parallel", "sharded_trotter.py")) + tuple(
                     ("examples", m + ".py") for m in EXAMPLES) + tuple(
                     ("tools", m + ".py") for m in ("__init__",) + TOOLS):
        assert os.path.join("flow_guided_krylov_torch", *part) in names


EXAMPLES = ("__init__", "benchmark", "bench", "large_system_benchmark",
            "moderate_system_benchmark", "skqd_lattice_validation",
            "skqd_validation", "skqd_necessity_test", "graft_entry")
TOOLS = ("roofline_connection", "repro_pt2_block", "sharded_scaling",
         "ccsd_bar")


@pytest.fixture(scope="module")
def imported_without_jax():
    """Import every CLI module (the examples and the tools) in one
    process that cannot import JAX or the JAX package (a meta-path finder
    refuses them), as on the card's machine: {module: error or None}."""
    import subprocess
    import sys
    code = (
        "import importlib, json, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "out = {}\n"
        "for name in sys.argv[1:]:\n"
        "    try:\n"
        "        m = importlib.import_module(\n"
        "            'flow_guided_krylov_torch.' + name)\n"
        "        out[name] = None if callable(getattr(m, 'main', None)) \\\n"
        "            else 'no main'\n"
        "    except Exception as exc:\n"
        "        out[name] = repr(exc)\n"
        "print(json.dumps(out))\n")
    names = ["examples." + m for m in EXAMPLES[1:]] + [
        "tools." + m for m in TOOLS]
    out = subprocess.run([sys.executable, "-c", code, *names],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", EXAMPLES[1:])
def test_entry_points_import_without_jax(name, imported_without_jax):
    got = imported_without_jax["examples." + name]
    assert got is None, got


@pytest.mark.parametrize("name", TOOLS)
def test_tools_import_without_jax(name, imported_without_jax):
    got = imported_without_jax["tools." + name]
    assert got is None, got
