"""No module of the benchmark imports JAX or the JAX package; the plain
reference imports nothing of the program either.  Top-level names (before
the first dot) are compared whole: ``repro_torch`` is not ``repro``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(path: Path) -> set[str]:
    return imported_text(path.read_text())


def imported_text(src: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert not names & (FORBIDDEN | {"repro_torch"})
    assert names <= {"__future__", "dataclasses", "math", "torch"}


def test_reference_relative_imports_stay_inside():
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1 and node.module in (None, "llama", "train")


def test_guard_catches_a_whole_name_only():
    assert imported_text("import repro.core") & FORBIDDEN
    assert not imported_text("import repro_torch.core") & FORBIDDEN
    assert imported_text("from jax import numpy") & FORBIDDEN

