"""The port stands alone: no file of ``src/repro_torch/`` (nor the root
``chip_smoke.py``) imports JAX or the JAX package ``repro``, and importing
the serving path loads no JAX."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


# the framework-free modules the port copies whole from the JAX package
COPIED_WHOLE = (
    "analysis/__init__.py", "analysis/__main__.py", "analysis/corpus.py",
    "analysis/cost.py", "analysis/coverage.py", "analysis/errors.py",
    "analysis/lint.py", "analysis/verify.py",
    "core/allreduce.py", "core/balance.py", "core/comm_sim.py", "core/detection.py",
    "core/event_sim.py", "core/executor_np.py", "core/failures.py",
    "core/migration.py", "core/partition.py", "core/recursive.py",
    "core/reranking.py", "core/schedule.py", "core/telemetry.py", "core/topology.py",
    "runtime/__init__.py", "runtime/campaign.py", "runtime/control_plane.py",
    "runtime/cosim.py", "runtime/inference.py", "runtime/scenarios.py",
    "data/synthetic.py",
)


def test_port_files_exist():
    assert (PORT / "__init__.py").exists()
    assert (REPO / "chip_smoke.py").exists()
    assert len(FILES) > 20
    for rel in COPIED_WHOLE + ("core/planner.py", "core/collectives.py"):
        assert (PORT / rel).exists(), rel


def _code(source: str) -> ast.Module:
    """``source`` parsed, every module, class and function docstring cut."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
    return tree


def _without_lint_targets(tree: ast.Module) -> tuple[ast.Module, str | None]:
    """``tree`` without its ``DEFAULT_LINT_TARGETS = ...`` statement, and
    that statement's value."""
    value = None
    for stmt in list(tree.body):
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and getattr(stmt.targets[0], "id", None) == "DEFAULT_LINT_TARGETS"):
            value = ast.literal_eval(stmt.value)
            tree.body.remove(stmt)
    return tree, value


@pytest.mark.parametrize("rel", COPIED_WHOLE)
def test_copied_modules_equal_their_originals(rel):
    """A module copied whole is its JAX original with ``repro.`` rewritten to
    ``repro_torch.``: the two syntax trees are equal once docstrings are cut.
    The one allowed difference is ``analysis/lint.py``'s
    ``DEFAULT_LINT_TARGETS``, which names the port's own folders."""
    jax_src = re.sub(r"\brepro\.", "repro_torch.",
                     (REPO / "src" / "repro" / rel).read_text())
    ours, ours_targets = _without_lint_targets(_code((PORT / rel).read_text()))
    theirs, jax_targets = _without_lint_targets(_code(jax_src))
    assert ast.dump(ours) == ast.dump(theirs), rel
    if rel == "analysis/lint.py":
        assert ours_targets == tuple(t.replace("src/repro/", "src/repro_torch/")
                                     for t in jax_targets)
        assert all(t.startswith("src/repro_torch/") for t in ours_targets)
    else:
        assert ours_targets is None and jax_targets is None


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_serving_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_training_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import sys, repro_torch.launch.train, repro_torch.core.collectives, "
            "repro_torch.analysis.corpus, repro_torch.core.executor_np; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
