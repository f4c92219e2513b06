"""What every cell shares: finding a cell's files by name, the statistics of a
window, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files are
found by name: ``workloads/<cell>.json`` (the driver and the limits of its
correctness check), ``configs/<config>.json`` (the model's sizes and
precisions) and ``traffic/<traffic>.json`` (the parameters the driver's
generator reads).  Each per-layer metric is read by ``metrics/<name>.py``,
whose ``read(records)`` returns a number, or None where the run has nothing
for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from typing import Any, Callable

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: top-level module names that no process printing a result may hold: JAX,
#: its libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(kind: str, name: str) -> dict:
    """``r2bench/<kind>/<name>.json``."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return json.loads((BENCH / kind / f"{name}.json").read_text())


@dataclasses.dataclass
class Cell:
    """One cell: its configuration, traffic, driver, limits and metrics."""

    name: str
    config: dict
    traffic: dict
    driver: str
    chips: int
    limits: dict
    end_to_end: list = dataclasses.field(default_factory=list)
    per_layer: list = dataclasses.field(default_factory=list)


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    spec = load("workloads", name)
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {spec['config']}, {spec['traffic']}; "
                         f"BENCHMARK.json {entry['config']}, {entry['traffic']}")
    return Cell(name=name, config=load("configs", entry["config"]),
                traffic=load("traffic", entry["traffic"]), driver=spec["driver"],
                chips=int(entry["chips"]), limits=spec["limits"],
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def load_reader(metric: str) -> Callable[[dict], float | None]:
    """``read`` of ``metrics/<metric>.py``."""
    if not NAME.match(metric):
        raise ValueError(f"metric name {metric!r} is not a benchmark name")
    path = BENCH / "metrics" / f"{metric}.py"
    mod_name = "r2bench.metrics." + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# statistics of a window
# ---------------------------------------------------------------------------

def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest value
    with at least ``q`` percent of ``values`` at or below it.  A request that
    failed enters as ``math.inf``, so it counts as a miss."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)), 1) - 1]


def merge_intervals(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip_intervals(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def union_length(intervals) -> float:
    return sum(b - a for a, b in merge_intervals(intervals))


def idle_gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval of ``busy`` covers."""
    gaps, t = [], lo
    for a, b in merge_intervals(clip_intervals(busy, lo, hi)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def forbidden_modules(modules=None) -> list[str]:
    """The names in ``sys.modules`` whose top-level name (before the first
    dot, compared whole) is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, the run's arguments, the device and
    the process's start (epoch seconds).  ``fault`` breaks the timed path on
    purpose (the harness's own tests); it is None in every benchmark run."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_process: float
    device: str = "cuda"
    fault: str | None = None           # "module:function"
    control: bool = False


def result(ctx: Context, out: dict) -> tuple[dict, list[str]]:
    """The result line of a driver's outcome and the lines of its checks.

    ``out``: ``e2e`` (end-to-end metrics by name), ``records`` (what the
    per-layer readers read), ``attempted``, ``failed``, ``checks`` (name ->
    (value, limit)), ``device`` and, traced, ``breakdown``.  ``correct`` is
    true when every check is a finite number at or below its limit."""
    cell = ctx.cell
    metrics: dict[str, dict[str, Any]] = {}
    if ctx.trace:
        for m in cell.per_layer:
            value = load_reader(m["name"])(out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(lim)} for k, (v, lim) in out["checks"].items()}
    correct = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks.values())
    line: dict[str, Any] = {"correct": correct, "attempted": int(out["attempted"]),
                            "failed": int(out["failed"]), "metrics": metrics,
                            "device": out["device"]}
    if ctx.trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return line, lines
