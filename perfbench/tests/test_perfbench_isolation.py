"""Nothing under perfbench/ imports JAX or the JAX package; nothing under
perfbench/reference/ imports the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "flow_guided_krylov_tpu"}
PROGRAM = {"flow_guided_krylov_torch"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert not found & (PROGRAM | JAX)
    # nor the benchmark's solve runners, which call the program
    assert "perfbench" not in found


def test_prefix_is_not_a_match():
    # the port's name starts with the JAX package's, and is allowed
    assert "flow_guided_krylov_torch".startswith("flow_guided_krylov_t")
    assert "flow_guided_krylov_torch" not in JAX


def test_scan_finds_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom flow_guided_krylov_tpu."
                 "ops import x\nimport importlib\n"
                 "importlib.import_module('flax.linen')\n")
    assert top_level_imports(f) == {"jax", "flow_guided_krylov_tpu",
                                    "importlib", "flax"}
