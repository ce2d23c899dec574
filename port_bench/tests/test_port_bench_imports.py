"""No module of the benchmark imports JAX, the JAX package or their
libraries (top-level names compared whole: ``vaura_tpu_torch`` is not
``vaura_tpu``), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vaura_tpu"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "vaura_tpu_torch" not in top_level_imports(path)


def test_the_check_compares_whole_names():
    from port_bench.run import FORBIDDEN_MODULES, forbidden_modules

    assert set(FORBIDDEN_MODULES) == FORBIDDEN
    assert forbidden_modules(["vaura_tpu_torch.models.vaura", "numpy"]) == []
    assert forbidden_modules(["vaura_tpu.models", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "vaura_tpu"]
