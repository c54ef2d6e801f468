"""No module of the benchmark imports JAX or the JAX package, and the
yardstick (references, counts) imports nothing of the port. Top-level
names are compared whole: ``repro_torch`` begins with ``repro``."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in
                                  ("reference", "counts")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_takes_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    from perfbench.harness.cell import loaded_forbidden
    before = dict(sys.modules)
    try:
        sys.modules.setdefault("repro_torch", type(sys)("repro_torch"))
        assert "repro" not in loaded_forbidden()
        sys.modules["repro.core"] = type(sys)("repro.core")
        assert loaded_forbidden() == ["repro"]
    finally:
        for name in set(sys.modules) - set(before):
            del sys.modules[name]


def test_driver_run_loads_no_jax(cell_name):
    from conftest import dry_run
    dry_run(cell_name, seconds=0.05)
    loaded = {name.split(".")[0] for name in sys.modules}
    assert not loaded & FORBIDDEN
