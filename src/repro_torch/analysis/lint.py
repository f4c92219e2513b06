"""Simulator-determinism lint: AST checks over the event engine + runtime.

The discrete-event simulator must be a pure function of its inputs — same
program, failures, and seed in, same timeline out.  Replay equality is what
the refactor-equivalence guards, the replan bit-exactness tests, and the
ledger↔trace cross-validation all assume.  This lint statically forbids
the ways that property quietly breaks:

=======  ====================================================================
rule     what it forbids
=======  ====================================================================
DET001   wall-clock reads (``time.time``/``monotonic``/``perf_counter``,
         ``datetime.now``/``utcnow``) — simulated time must come from the
         event queue, never the host clock
DET002   unseeded randomness (bare ``random.*`` module calls, legacy
         ``np.random.*`` globals, ``default_rng()`` / ``random.Random()``
         with no seed argument) — seeded generator objects are fine
DET003   iteration over a bare ``set``/``frozenset`` in event-ordering code
         (``for`` loops, comprehensions) — set order is hash-randomized
         across runs; wrap in ``sorted(...)``
DET004   float ``==``/``!=`` where either side looks like a simulated
         timestamp (named ``now``/``t``/``t0``/``dt``/...,
         contains ``time``, ends with ``_at``) — compare with a tolerance
         or restructure
DET005   mutation of frozen IR dataclasses (``object.__setattr__`` outside
         ``__post_init__``, attribute assignment through a name annotated
         with a frozen class) — the IR is immutable by contract
=======  ====================================================================

Findings carry file/line/rule and are stable across runs.  Run via
``python -m repro_torch.analysis lint [paths...]``.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable, Sequence

__all__ = ["LintFinding", "lint_source", "lint_paths", "DEFAULT_LINT_TARGETS"]

#: directories the CI determinism gate covers (relative to the repo root):
#: the simulator core and runtime, plus the analysis package itself (the
#: static analyses must be as replay-deterministic as what they check) and
#: the serving engine (its virtual-time request loop shares the contract)
DEFAULT_LINT_TARGETS = ("src/repro_torch/core", "src/repro_torch/runtime",
                        "src/repro_torch/analysis", "src/repro_torch/serving")

_WALL_CLOCK_TIME_ATTRS = {"time", "monotonic", "perf_counter", "time_ns",
                          "monotonic_ns", "perf_counter_ns"}
_WALL_CLOCK_DT_ATTRS = {"now", "utcnow", "today"}
_RANDOM_MODULE_FUNCS = {
    "random", "randint", "randrange", "uniform", "gauss", "normalvariate",
    "choice", "choices", "sample", "shuffle", "betavariate", "expovariate",
    "seed",
}
_TIMEY_EXACT = {"now", "t", "t0", "t1", "dt", "start", "end", "deadline",
                "eta", "when"}

# builtins whose result doesn't depend on iteration order: iterating a set
# through these cannot leak nondeterminism
_ORDER_SAFE_CALLS = {"sorted", "min", "max", "sum", "len", "any", "all",
                     "set", "frozenset"}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _is_timey(name: str) -> bool:
    low = name.lower()
    return (low in _TIMEY_EXACT or "time" in low or low.endswith("_at")
            or low.startswith("t_"))


def _name_of(node: ast.expr) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        return _name_of(node.func)
    return None


def _dotted(node: ast.expr) -> str | None:
    """'a.b.c' for nested attribute access rooted at a Name, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, frozen_classes: set[str]):
        self.path = path
        self.frozen_classes = frozen_classes
        self.findings: list[LintFinding] = []
        # names known to hold sets in the current scope(s)
        self._set_names: list[set[str]] = [set()]
        # attribute names (self.X) known to hold sets, per enclosing class
        self._set_attrs: list[set[str]] = [set()]
        # names annotated with a frozen dataclass type
        self._frozen_names: list[dict[str, str]] = [{}]
        self._in_post_init = 0

    # -- helpers ----------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(
            LintFinding(self.path, getattr(node, "lineno", 0), rule, message))

    def _ann_is_set(self, ann: ast.expr | None) -> bool:
        if ann is None:
            return False
        base = ann.value if isinstance(ann, ast.Subscript) else ann
        name = _name_of(base)
        return name in {"set", "frozenset", "Set", "FrozenSet", "MutableSet"}

    def _ann_frozen_class(self, ann: ast.expr | None) -> str | None:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.strip().split("[")[0].split(".")[-1]
            return name if name in self.frozen_classes else None
        name = _name_of(ann.value if isinstance(ann, ast.Subscript) else ann)
        return name if name in self.frozen_classes else None

    def _expr_is_set(self, node: ast.expr) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Name):
            return any(node.id in scope for scope in self._set_names)
        if isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name) and node.value.id == "self"
                    and any(node.attr in s for s in self._set_attrs)):
                return True
            return False
        if isinstance(node, ast.Call):
            fname = _name_of(node.func)
            if fname in {"set", "frozenset"}:
                return True
            if fname in {"union", "intersection", "difference",
                         "symmetric_difference", "copy"}:
                return self._expr_is_set(node.func.value) if isinstance(
                    node.func, ast.Attribute) else False
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return self._expr_is_set(node.left) or self._expr_is_set(node.right)
        return False

    # -- scope bookkeeping ------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._set_attrs.append(set())
        # pre-scan: attribute annotations + __init__ assignments
        for sub in ast.walk(node):
            if isinstance(sub, ast.AnnAssign) and self._ann_is_set(
                    sub.annotation):
                tgt = sub.target
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    self._set_attrs[-1].add(tgt.attr)
            if isinstance(sub, ast.Assign) and self._expr_is_set(sub.value):
                for tgt in sub.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        self._set_attrs[-1].add(tgt.attr)
        self.generic_visit(node)
        self._set_attrs.pop()

    def _visit_function(self, node) -> None:
        is_post_init = node.name == "__post_init__"
        self._in_post_init += is_post_init
        self._set_names.append(set())
        self._frozen_names.append({})
        for arg in list(node.args.args) + list(node.args.kwonlyargs):
            if self._ann_is_set(arg.annotation):
                self._set_names[-1].add(arg.arg)
            frozen = self._ann_frozen_class(arg.annotation)
            if frozen:
                self._frozen_names[-1][arg.arg] = frozen
        self.generic_visit(node)
        self._frozen_names.pop()
        self._set_names.pop()
        self._in_post_init -= is_post_init

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._expr_is_set(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._set_names[-1].add(tgt.id)
        else:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._set_names[-1].discard(tgt.id)
        self._check_frozen_target_assign(node.targets, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name):
            if self._ann_is_set(node.annotation):
                self._set_names[-1].add(node.target.id)
            frozen = self._ann_frozen_class(node.annotation)
            if frozen:
                self._frozen_names[-1][node.target.id] = frozen
        self._check_frozen_target_assign([node.target], node)
        self.generic_visit(node)

    # -- DET001 / DET002: calls ------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if dotted:
            head, _, tail = dotted.partition(".")
            if head == "time" and tail in _WALL_CLOCK_TIME_ATTRS:
                self._emit(node, "DET001",
                           f"wall-clock call {dotted}() in simulator code; "
                           f"simulated time must come from the event queue")
            if tail.split(".")[-1] in _WALL_CLOCK_DT_ATTRS and (
                    "datetime" in dotted or head == "datetime"):
                self._emit(node, "DET001",
                           f"wall-clock call {dotted}() in simulator code")
            if head == "random" and tail in _RANDOM_MODULE_FUNCS:
                self._emit(node, "DET002",
                           f"unseeded module-level {dotted}(); use a seeded "
                           f"random.Random(seed) instance")
            if dotted.endswith("np.random." + tail.split(".")[-1]) or \
                    dotted.startswith("numpy.random."):
                last = tail.split(".")[-1]
                if last not in {"Generator", "default_rng", "SeedSequence",
                                "RandomState"}:
                    self._emit(node, "DET002",
                               f"legacy global numpy RNG {dotted}(); use "
                               f"np.random.default_rng(seed)")
        fname = _name_of(node.func)
        if fname in {"default_rng", "RandomState", "Random"} and \
                not node.args and not node.keywords:
            self._emit(node, "DET002",
                       f"{fname}() constructed without a seed")
        # DET005: object.__setattr__ outside __post_init__
        if dotted == "object.__setattr__" and not self._in_post_init:
            self._emit(node, "DET005",
                       "object.__setattr__ outside __post_init__ mutates a "
                       "frozen dataclass; build a new instance instead")
        self.generic_visit(node)

    # -- DET003: iteration over bare sets --------------------------------

    def _check_iter(self, node: ast.AST, iter_expr: ast.expr) -> None:
        if self._expr_is_set(iter_expr):
            self._emit(node, "DET003",
                       "iteration over a bare set; order is "
                       "hash-randomized — wrap in sorted(...)")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        # set/frozenset comprehensions can't leak order; others can
        order_safe = isinstance(node, ast.SetComp)
        if not order_safe:
            for gen in node.generators:
                self._check_iter(node, gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    def visit_Compare(self, node: ast.Compare) -> None:
        # DET004: float equality on time-like values
        operands = [node.left, *node.comparators]
        for op, left, right in zip(node.ops, operands, operands[1:]):
            if not isinstance(op, (ast.Eq, ast.NotEq)):
                continue
            for side, other in ((left, right), (right, left)):
                name = _name_of(side)
                if name is None or not _is_timey(name):
                    continue
                # comparisons against None/sentinel ints are fine; flag
                # only float-typed literals or other time-like operands
                if isinstance(other, ast.Constant) and (
                        other.value is None
                        or isinstance(other.value, (bool, int, str))):
                    continue
                other_name = _name_of(other)
                if (isinstance(other, ast.Constant)
                        and isinstance(other.value, float)) or (
                        other_name is not None and _is_timey(other_name)):
                    self._emit(node, "DET004",
                               f"float equality on time-like value "
                               f"{name!r}; compare with a tolerance")
                    break
        self.generic_visit(node)

    # -- DET005: frozen-instance attribute assignment ---------------------

    def _check_frozen_target_assign(self, targets, node) -> None:
        for tgt in targets:
            if not isinstance(tgt, ast.Attribute):
                continue
            base = tgt.value
            if not isinstance(base, ast.Name):
                continue
            for scope in self._frozen_names:
                if base.id in scope:
                    self._emit(
                        node, "DET005",
                        f"assignment to {base.id}.{tgt.attr} mutates frozen "
                        f"dataclass {scope[base.id]}; use dataclasses."
                        f"replace()")
                    break

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_frozen_target_assign([node.target], node)
        self.generic_visit(node)


def _frozen_classes_in(trees: Iterable[ast.AST]) -> set[str]:
    """Names of every ``@dataclass(frozen=True)`` class across the files
    being linted (frozen-mutation checks resolve annotations against
    these)."""
    found: set[str] = set()
    for tree in trees:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                dname = _dotted(dec.func) or ""
                if dname.split(".")[-1] != "dataclass":
                    continue
                for kw in dec.keywords:
                    if (kw.arg == "frozen"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True):
                        found.add(node.name)
    return found


def lint_source(source: str, path: str = "<string>",
                frozen_classes: set[str] | None = None) -> list[LintFinding]:
    """Lint one source string; ``frozen_classes`` augments the set
    discovered in the source itself."""
    tree = ast.parse(source, filename=path)
    frozen = _frozen_classes_in([tree])
    if frozen_classes:
        frozen |= frozen_classes
    linter = _Linter(path, frozen)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths: Sequence[str | pathlib.Path]) -> list[LintFinding]:
    """Lint every ``.py`` file under ``paths`` (files or directories).

    Frozen-dataclass names are collected across *all* files first, so a
    frozen class defined in ``core/schedule.py`` is recognized when
    ``runtime/`` code annotates with it.
    """
    files: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    sources = {f: f.read_text() for f in files}
    trees = [ast.parse(src, filename=str(f)) for f, src in sources.items()]
    frozen = _frozen_classes_in(trees)
    findings: list[LintFinding] = []
    for f, src in sources.items():
        findings.extend(lint_source(src, str(f), frozen_classes=frozen))
    return sorted(findings, key=lambda x: (x.path, x.line, x.rule))
